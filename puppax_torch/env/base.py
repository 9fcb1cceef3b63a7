"""The batched env State, and carrying a ``puppax`` state across.

Counterpart of ``puppax/env/base.py``. Every field has a leading env axis.
The rollout fast lane reads only qpos/qvel of the physics (the JAX lane
poisons the other leaves with NaN, ``puppax/env/rollout.py:341-355``), so
its states carry ``pipeline_state=None``. The standard lane
(``PupperV3Env.step``) fills ``pipeline_state`` with the last forward
pass's caches (``physics/pipeline.py::PhysicsState``, re-exported here):
those K2 writes in the fused lane, those of K1 or ``pipeline_step`` in the
physics-only lane.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from puppax_torch import random
from puppax_torch.physics.pipeline import PhysicsState, physics_state_from_caches

__all__ = ["PhysicsState", "State", "physics_state_from_caches", "state_from_jax"]


@dataclass(frozen=True)
class State:
    """Batched environment state: qpos (B, nq), qvel (B, nv), obs (B, obs),
    reward (B,), done (B,), metrics and info dicts of (B, ...) tensors, and
    the physics caches of the standard lane (None on fast-lane states)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]
    pipeline_state: Optional[PhysicsState] = None

    def replace(self, **updates) -> "State":
        return dataclasses.replace(self, **updates)


def _to_torch(x, device):
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


# info fields the fast lane and the wrappers read (besides "rng", the
# envs' jax keys)
_INFO_KEYS = (
    "last_act", "action_buffer", "imu_buffer", "last_vel", "command",
    "last_contact", "feet_air_time", "rewards", "kick", "step",
    "desired_world_z_in_body_frame", "steps", "truncation", "first_qpos",
    "first_qvel", "first_obs", "gait_phase", "privileged_obs", "first_privileged_obs",
    "difficulty",
)


def _physics_from_jax(ps, device) -> PhysicsState:
    t = lambda x: _to_torch(x, device)  # noqa: E731
    return PhysicsState(
        qpos=t(ps.qpos), qvel=t(ps.qvel), qacc=t(ps.qacc), x_pos=t(ps.x_pos),
        x_rot=t(ps.x_rot), xd_vel=t(ps.xd_vel), xd_ang=t(ps.xd_ang), xpos=t(ps.xpos),
        site_xpos=t(ps.site_xpos), qfrc_actuator=t(ps.qfrc_actuator),
        contact_dist=t(ps.contact.dist), contact_pos=t(ps.contact.pos),
    )


def state_from_jax(state_numpy, device=None) -> State:
    """A ``puppax`` wrapped reset/step State (its leaves as numpy, e.g. via
    ``jax.tree_util.tree_map(np.asarray, state)``) as the port's State,
    with its PhysicsState caches and the AutoReset ``first_pipeline_state``
    where the JAX state has one."""
    ps = state_numpy.pipeline_state
    info = {k: _to_torch(state_numpy.info[k], device)
            for k in _INFO_KEYS if k in state_numpy.info}
    if "rng" in state_numpy.info:
        info["rng"] = random.from_key_data(state_numpy.info["rng"], device or "cpu")
    if "first_pipeline_state" in state_numpy.info:
        info["first_pipeline_state"] = _physics_from_jax(
            state_numpy.info["first_pipeline_state"], device
        )
    return State(
        qpos=_to_torch(ps.qpos, device),
        qvel=_to_torch(ps.qvel, device),
        obs=_to_torch(state_numpy.obs, device),
        reward=_to_torch(state_numpy.reward, device),
        done=_to_torch(state_numpy.done, device),
        metrics=_to_torch(dict(state_numpy.metrics), device),
        info=info,
        pipeline_state=_physics_from_jax(ps, device),
    )
