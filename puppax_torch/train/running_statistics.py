"""Running observation normalization statistics: the state and ``normalize``.

Counterpart of ``puppax/train/running_statistics.py``. The field names
(``count``, ``mean``, ``summed_variance``, ``std``) are part of the export
ABI and stay as they are. ``update`` (the Welford fold) comes with the
learner slice (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class RunningStatisticsState:
    """Streaming mean/std state of an ``(obs_dim,)`` observation."""

    count: torch.Tensor  # () float32
    mean: torch.Tensor  # (obs_dim,)
    summed_variance: torch.Tensor  # (obs_dim,)
    std: torch.Tensor  # (obs_dim,)

    def replace(self, **updates) -> "RunningStatisticsState":
        return replace(self, **updates)


def init_state(obs_dim: int, device=None) -> RunningStatisticsState:
    return RunningStatisticsState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=torch.zeros(obs_dim, dtype=torch.float32, device=device),
        summed_variance=torch.zeros(obs_dim, dtype=torch.float32, device=device),
        std=torch.ones(obs_dim, dtype=torch.float32, device=device),
    )


def from_jax(mean, std, count=0.0, summed_variance=None, device=None) -> RunningStatisticsState:
    """A ``puppax`` normalizer state (its fields as numpy) as the port's."""

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    mean = t(mean)
    return RunningStatisticsState(
        count=t(count),
        mean=mean,
        summed_variance=torch.zeros_like(mean) if summed_variance is None else t(summed_variance),
        std=t(std),
    )


def normalize(batch: torch.Tensor, state: RunningStatisticsState) -> torch.Tensor:
    return (batch - state.mean) / state.std
