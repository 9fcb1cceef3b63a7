"""Reward terms over the physics state, batched over envs.

Counterpart of ``puppax/env/rewards.py``: the same 16 functions (the step
core calls ``reward_stand_still`` and ``reward_geom_collision`` twice each,
18 terms in all) on the port's ``PhysicsState``, every argument and result
with a leading env axis. The world body is dropped from the ``x_*`` and
``xd_*`` fields, so the torso is link 0.
"""

from __future__ import annotations

import torch

from refport.ops import math
from refport.physics.pipeline import PhysicsState


def _unit_z(ref: torch.Tensor) -> torch.Tensor:
    """(0, 0, 1) of ``ref``'s dtype and device, made on the device (no
    host-to-device copy)."""
    z = ref.new_zeros(3)
    z[2] = 1.0
    return z


def reward_lin_vel_z(ps: PhysicsState) -> torch.Tensor:
    """Penalize z-axis base linear velocity."""
    return torch.square(ps.xd_vel[:, 0, 2])


def reward_ang_vel_xy(ps: PhysicsState) -> torch.Tensor:
    """Penalize xy-axes base angular velocity."""
    return torch.sum(torch.square(ps.xd_ang[:, 0, :2]), -1)


def reward_tracking_orientation(desired_world_z_in_body_frame: torch.Tensor, ps: PhysicsState,
                                tracking_sigma: float) -> torch.Tensor:
    """Track the desired body orientation."""
    world_z_in_body_frame = math.rotate(_unit_z(ps.x_rot), math.quat_inv(ps.x_rot[:, 0]))
    error = torch.sum(torch.square(world_z_in_body_frame - desired_world_z_in_body_frame), -1)
    return torch.exp(-error / tracking_sigma)


def reward_orientation(ps: PhysicsState) -> torch.Tensor:
    """Penalize non-flat base orientation."""
    rot_up = math.rotate(_unit_z(ps.x_rot), ps.x_rot[:, 0])
    return torch.sum(torch.square(rot_up[:, :2]), -1)


def reward_torques(torques: torch.Tensor) -> torch.Tensor:
    """L2 torque penalty."""
    return torch.sum(torch.square(torques), -1)


def reward_joint_acceleration(joint_vel: torch.Tensor, last_joint_vel: torch.Tensor,
                              dt: float) -> torch.Tensor:
    """Finite-difference joint acceleration penalty."""
    return torch.sum(torch.square((joint_vel - last_joint_vel) / dt), -1)


def reward_mechanical_work(torques: torch.Tensor, velocities: torch.Tensor) -> torch.Tensor:
    """L1 mechanical work penalty."""
    return torch.sum(torch.abs(torques * velocities), -1)


def reward_action_rate(act: torch.Tensor, last_act: torch.Tensor) -> torch.Tensor:
    """Penalize action changes."""
    return torch.sum(torch.square(act - last_act), -1)


def reward_tracking_lin_vel(commands: torch.Tensor, ps: PhysicsState,
                            tracking_sigma) -> torch.Tensor:
    """Track the commanded xy linear velocity in the body frame."""
    local_vel = math.rotate(ps.xd_vel[:, 0], math.quat_inv(ps.x_rot[:, 0]))
    lin_vel_error = torch.sum(torch.square(commands[:, :2] - local_vel[:, :2]), -1)
    return torch.exp(-lin_vel_error / tracking_sigma)


def reward_tracking_ang_vel(commands: torch.Tensor, ps: PhysicsState,
                            tracking_sigma) -> torch.Tensor:
    """Track the commanded yaw rate in the body frame."""
    base_ang_vel = math.rotate(ps.xd_ang[:, 0], math.quat_inv(ps.x_rot[:, 0]))
    ang_vel_error = torch.square(commands[:, 2] - base_ang_vel[:, 2])
    return torch.exp(-ang_vel_error / tracking_sigma)


def reward_feet_air_time(air_time: torch.Tensor, first_contact: torch.Tensor,
                         commands: torch.Tensor, minimum_airtime: float = 0.1) -> torch.Tensor:
    """Reward swing time above the minimum at touch-down, gated off for
    near-zero commands."""
    rew_air_time = torch.sum((air_time - minimum_airtime) * first_contact, -1)
    return rew_air_time * (math.normalize(commands[:, :3])[1] > 0.05)


def reward_abduction_angle(joint_angles: torch.Tensor,
                           desired_abduction_angles: torch.Tensor) -> torch.Tensor:
    """Penalize abduction joints away from the desired angles."""
    return torch.sum(torch.square(joint_angles[:, 1::3] - desired_abduction_angles), -1)


def reward_stand_still(commands: torch.Tensor, joint_angles: torch.Tensor,
                       default_pose: torch.Tensor, command_threshold: float) -> torch.Tensor:
    """Penalize motion when the command is near zero."""
    return torch.sum(torch.abs(joint_angles - default_pose), -1) * (
        math.normalize(commands[:, :3])[1] < command_threshold)


def reward_foot_slip(ps: PhysicsState, contact_filt: torch.Tensor, feet_site_id,
                     lower_leg_body_id) -> torch.Tensor:
    """Penalize tangential foot velocity while in contact. Foot velocity by
    rigid-body transport from the lower-leg link: v_link + omega_link x
    (p_foot - p_link), link indices in the world-dropped arrays."""
    dev = ps.xpos.device
    feet = torch.as_tensor(feet_site_id, dtype=torch.int64, device=dev)
    legs = torch.as_tensor(lower_leg_body_id, dtype=torch.int64, device=dev)
    feet_offset = ps.site_xpos[:, feet] - ps.xpos[:, legs]
    foot_vel = ps.xd_vel[:, legs - 1] + torch.linalg.cross(ps.xd_ang[:, legs - 1], feet_offset)
    return torch.sum(torch.square(foot_vel[..., :2]) * contact_filt[..., None], dim=(-2, -1))


def reward_termination(done: torch.Tensor, step: torch.Tensor, step_threshold: int):
    """Penalize early termination."""
    return done & (step < step_threshold)


def reward_geom_collision(ps: PhysicsState, geom_ids: torch.Tensor, contact_geom1: torch.Tensor,
                          contact_geom2: torch.Tensor) -> torch.Tensor:
    """Count the active contacts touching any of ``geom_ids``: each pair of
    (geom id, contact) with either contact geom equal to the id and a
    penetrating distance counts once. ``contact_geom1``/``contact_geom2``
    are the report's static pair geoms (``pipeline.pair_contact_statics``)."""
    ids = geom_ids.reshape(-1, 1)
    hit = (contact_geom1[None, :] == ids) | (contact_geom2[None, :] == ids)  # (n_ids, npair)
    pen = ps.contact_dist < 0.0  # (B, npair)
    return torch.sum(hit[None] & pen[:, None, :], dim=(-2, -1)).to(ps.contact_dist.dtype)
