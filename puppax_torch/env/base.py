"""The batched env State, and carrying a ``puppax`` state across.

Counterpart of ``puppax/env/base.py``. The JAX State holds a full
PhysicsState; the rollout fast lane reads only qpos/qvel of it (the other
leaves are poisoned with NaN, ``puppax/env/rollout.py:341-355``), so the
port's State holds just those two. Every field has a leading env axis.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch


@dataclass(frozen=True)
class State:
    """Batched environment state: qpos (B, nq), qvel (B, nv), obs (B, obs),
    reward (B,), done (B,), metrics and info dicts of (B, ...) tensors."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]

    def replace(self, **updates) -> "State":
        return dataclasses.replace(self, **updates)


def _to_torch(x, device):
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


# info fields the fast lane and the wrappers read (the JAX rng keys are
# not carried: the port draws from a torch.Generator)
_INFO_KEYS = (
    "last_act", "action_buffer", "imu_buffer", "last_vel", "command",
    "last_contact", "feet_air_time", "rewards", "kick", "step",
    "desired_world_z_in_body_frame", "steps", "truncation", "first_qpos",
    "first_qvel", "first_obs",
)


def state_from_jax(state_numpy, device=None) -> State:
    """A ``puppax`` wrapped reset/step State (its leaves as numpy, e.g. via
    ``jax.tree_util.tree_map(np.asarray, state)``) as the port's State."""
    ps = state_numpy.pipeline_state
    info = {k: _to_torch(state_numpy.info[k], device)
            for k in _INFO_KEYS if k in state_numpy.info}
    return State(
        qpos=_to_torch(ps.qpos, device),
        qvel=_to_torch(ps.qvel, device),
        obs=_to_torch(state_numpy.obs, device),
        reward=_to_torch(state_numpy.reward, device),
        done=_to_torch(state_numpy.done, device),
        metrics=_to_torch(dict(state_numpy.metrics), device),
        info=info,
    )
