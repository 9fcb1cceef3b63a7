"""Configs: reward scales and the experiment dataclasses."""

from refport.configs.experiment import (
    DomainRandomizationConfig,
    EnvConfig,
    ExperimentConfig,
    StartPositionConfig,
    TrainConfig,
    apply_overrides,
    config_hash,
    from_dict,
    to_dict,
)
from refport.configs.rewards import get_config

__all__ = [
    "DomainRandomizationConfig",
    "EnvConfig",
    "ExperimentConfig",
    "StartPositionConfig",
    "TrainConfig",
    "apply_overrides",
    "config_hash",
    "from_dict",
    "get_config",
    "to_dict",
]
