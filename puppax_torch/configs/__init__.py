"""Configs: reward scales and the experiment dataclasses."""

from puppax_torch.configs.experiment import (
    DomainRandomizationConfig,
    EnvConfig,
    StartPositionConfig,
    TrainConfig,
)
from puppax_torch.configs.rewards import get_config

__all__ = [
    "DomainRandomizationConfig",
    "EnvConfig",
    "StartPositionConfig",
    "TrainConfig",
    "get_config",
]
