"""The rollout's transition record.

Counterpart of ``puppax/train/acting.py::Transition``: one env transition
per field, time-major ``(T, B, ...)``, as the PPO loss consumes it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch


@dataclass(frozen=True)
class Transition:
    observation: torch.Tensor
    action: torch.Tensor  # post-tanh action fed to the env
    reward: torch.Tensor
    discount: torch.Tensor  # 1 - done
    next_observation: torch.Tensor
    truncation: torch.Tensor  # episode cut off at the horizon (not a failure)
    policy_extras: Dict[str, torch.Tensor]  # log_prob, raw_action (pre-tanh)
    metrics: Dict[str, torch.Tensor] = field(default_factory=dict)
    extras: Dict[str, torch.Tensor] = field(default_factory=dict)
