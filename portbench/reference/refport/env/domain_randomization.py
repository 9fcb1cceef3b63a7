"""Domain randomization: per-env model leaves + start-pose sampling.

Counterpart of ``puppax/env/domain_randomization.py``. ``domain_randomize``
draws, per env, one friction scalar broadcast to every geom's slide
friction (the contract ``soa_env`` relies on: every pair's combined mu is
that scalar), a kp and a kd multiplier, a torso COM shift, per-body
inertia scales and per-body mass scales, and returns the model with those
six leaves batched as ``(B, ...)`` tensors. Every draw comes from the
envs' jax keys (``refport.random``), in the JAX chain's order.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from refport import random
from refport.model.mjcf import RobotModel


def domain_randomize(
    model: RobotModel,
    keys: torch.Tensor,
    friction_range: Tuple = (0.6, 1.4),
    kp_multiplier_range: Tuple = (0.75, 1.25),
    kd_multiplier_range: Tuple = (0.5, 2.0),
    body_com_x_shift_range: Tuple = (-0.03, 0.03),
    body_com_y_shift_range: Tuple = (-0.01, 0.01),
    body_com_z_shift_range: Tuple = (-0.02, 0.02),
    body_inertia_scale_range: Tuple = (0.7, 1.3),
    body_mass_scale_range: Tuple = (0.7, 1.3),
) -> RobotModel:
    """The model with the six DR leaves batched over the envs, one per key
    of ``keys`` ``(B, 2)``, in the JAX chain's split and draw order
    (``puppax/env/domain_randomization.py:51-115``)."""
    B, dev = keys.shape[0], keys.device

    def leaf(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    rng, key = random.split(keys, 2).unbind(1)
    friction = random.uniform(key, (1,), *friction_range)
    geom_friction = leaf(model.geom_friction).expand(B, -1, -1).clone()
    geom_friction[:, :, 0] = friction

    k = random.split(rng, 3)
    rng = k[:, 0]
    gain0, bias0 = leaf(model.actuator_gainprm), leaf(model.actuator_biasprm)
    kp = random.uniform(k[:, 1], (1,), *kp_multiplier_range) * gain0[:, 0]
    kd = random.uniform(k[:, 2], (1,), *kd_multiplier_range) * (-bias0[:, 2])
    gain = gain0.expand(B, -1, -1).clone()
    gain[:, :, 0] = kp
    bias = bias0.expand(B, -1, -1).clone()
    bias[:, :, 1] = -kp
    bias[:, :, 2] = -kd

    rng, key = random.split(rng, 2).unbind(1)
    shift_lo = (body_com_x_shift_range[0], body_com_y_shift_range[0],
                body_com_z_shift_range[0])
    shift_hi = (body_com_x_shift_range[1], body_com_y_shift_range[1],
                body_com_z_shift_range[1])
    com_shift = random.uniform(key, (3,), shift_lo, shift_hi)
    body_ipos = leaf(model.body_ipos).expand(B, -1, -1).clone()
    body_ipos[:, 1] = body_ipos[:, 1] + com_shift

    rng, key = random.split(rng, 2).unbind(1)
    inertia = leaf(model.body_inertia)
    body_inertia = inertia * random.uniform(key, tuple(inertia.shape), *body_inertia_scale_range)
    rng, key = random.split(rng, 2).unbind(1)
    mass = leaf(model.body_mass)
    body_mass = mass * random.uniform(key, tuple(mass.shape), *body_mass_scale_range)
    return model.with_leaves(
        geom_friction=geom_friction,
        actuator_gainprm=gain,
        actuator_biasprm=bias,
        body_ipos=body_ipos,
        body_inertia=body_inertia,
        body_mass=body_mass,
    )


def qpos_from_draws(qpos: torch.Tensor, pos: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Start poses: free-joint xyz = pos (B, 3), orientation = the yaw
    (B,) rotation about z; the joints keep ``qpos``'s values."""
    B = pos.shape[0]
    out = qpos.to(pos.device, torch.float32).expand(B, -1).clone()
    out[:, :3] = pos
    half = yaw / 2
    zero = torch.zeros_like(half)
    out[:, 3:7] = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], -1)
    return out


def randomize_qpos(qpos, start_position_config, keys: torch.Tensor) -> torch.Tensor:
    """Uniform start xyz in the config's box + uniform yaw in [-pi, pi),
    one start pose per key of ``keys`` ``(B, 2)`` (``puppax/env/
    domain_randomization.py:188-210``, its split order)."""
    c = start_position_config
    k = random.split(keys, 3)
    pos = random.uniform(k[:, 1], (3,), (c.x_min, c.y_min, c.z_min), (c.x_max, c.y_max, c.z_max))
    yaw = random.uniform(k[:, 2], (1,), -math.pi, math.pi)[:, 0]
    return qpos_from_draws(torch.as_tensor(np.asarray(qpos), device=keys.device), pos, yaw)
