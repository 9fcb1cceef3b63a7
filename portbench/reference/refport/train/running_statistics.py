"""Running observation normalization statistics: the state, ``update`` and
``normalize``.

Counterpart of ``puppax/train/running_statistics.py``. The field names
(``count``, ``mean``, ``summed_variance``, ``std``) are part of the export
ABI and stay as they are.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from refport import utils


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
    device = utils.resolve_device(device)
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


def update(state: RunningStatisticsState, batch: torch.Tensor,
           std_min_value: float = 1e-6) -> RunningStatisticsState:
    """Fold a batch ``(..., obs_dim)`` into the running statistics (Chan's
    parallel Welford update, ``puppax/train/running_statistics.py:41-81``)
    in one process."""
    obs_dim = state.mean.shape[-1]
    flat = batch.reshape(-1, obs_dim)
    batch_count = float(flat.shape[0])
    batch_mean = torch.mean(flat, dim=0)
    batch_m2 = torch.sum(torch.square(flat - batch_mean), dim=0)
    new_count = state.count + batch_count
    delta = batch_mean - state.mean
    new_mean = state.mean + delta * (batch_count / new_count)
    new_m2 = (state.summed_variance + batch_m2
              + torch.square(delta) * state.count * batch_count / new_count)
    new_std = torch.sqrt(torch.clamp_min(new_m2 / new_count, 0.0))
    new_std = torch.clamp_min(new_std, std_min_value)
    return RunningStatisticsState(count=new_count, mean=new_mean,
                                  summed_variance=new_m2, std=new_std)


def normalize(batch: torch.Tensor, state: RunningStatisticsState) -> torch.Tensor:
    return (batch - state.mean) / state.std
