"""Reward configuration: the 18 named scales + tracking sigma.

Counterpart of ``puppax/configs/rewards.py`` as a plain dict
(``config["rewards"]["scales"][k]``) instead of an ml_collections tree.
"""

from __future__ import annotations

from typing import Any, Dict


def get_config() -> Dict[str, Any]:
    """Reward config for the Pupper v3 joystick-locomotion task."""
    scales = dict(
        tracking_lin_vel=1.5,
        tracking_ang_vel=0.8,
        lin_vel_z=-2.0,
        ang_vel_xy=-0.05,
        orientation=-5.0,
        tracking_orientation=1.0,
        torques=-0.0002,
        joint_acceleration=-1e-6,
        mechanical_work=-0.00,
        action_rate=-0.01,
        feet_air_time=0.2,
        stand_still=-0.5,
        stand_still_joint_velocity=-0.1,
        abduction_angle=-0.1,
        termination=-100.0,
        foot_slip=-0.1,
        knee_collision=-1.0,
        body_collision=-1.0,
    )
    return {"rewards": {"scales": scales, "tracking_sigma": 0.25}}
