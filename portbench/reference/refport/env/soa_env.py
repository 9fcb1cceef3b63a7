"""The env step's row layouts.

Counterpart of the layout part of ``puppax/env/soa_env.py``: the
``(rows, B)`` row-major float32 blocks that the kernels read and write
(``rows_block``, ``env_block``, ``noise_block``, ``aux_row_map``,
``block_rows``), the host-side digest of the env's constants
(``_EnvStatic``) and the gait clock's tick. The emission of the env step
and its kernels are left out: the reference steps the env through
``PupperV3Env._step_core`` and ``pipeline.pipeline_step``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from refport.physics import soa

# fixed reward-term order (insertion order of the JAX step core's dict)
REWARD_ORDER = (
    "tracking_lin_vel",
    "tracking_ang_vel",
    "tracking_orientation",
    "lin_vel_z",
    "ang_vel_xy",
    "orientation",
    "torques",
    "joint_acceleration",
    "mechanical_work",
    "action_rate",
    "stand_still",
    "stand_still_joint_velocity",
    "abduction_angle",
    "feet_air_time",
    "foot_slip",
    "termination",
    "knee_collision",
    "body_collision",
)


class _EnvStatic:
    """Host-side env constants digest (Python floats only)."""

    def __init__(self, host: Dict[str, np.ndarray], env, s: soa._Static):
        self.default_pose = [float(x) for x in host["default_pose"]]
        self.action_scale = float(host["action_scale"])
        self.lowers = [float(x) for x in host["joint_lower_limits"]]
        self.uppers = [float(x) for x in host["joint_upper_limits"]]
        self.Da = int(len(host["latency_distribution"]))
        self.Di = int(len(host["imu_latency_distribution"]))
        self.dt = float(env._dt)
        self.foot_radius = float(env._foot_radius)
        self.use_imu = bool(env._use_imu)
        self.obs_dim = int(env.observation_dim)
        self.hist = int(env._observation_history) * self.obs_dim
        self.dphase = float(env._dphase)  # the gait clock's float32 tick (K4)
        self.feet_sites = [int(i) for i in env._feet_site_id]
        self.torso_body = int(env._torso_idx)
        self.lower_leg_bodies = [int(i) for i in env._lower_leg_body_id]
        self.cos_term = float(np.cos(env._terminal_body_angle))
        self.terminal_z = float(env._terminal_body_z)
        self.early_term = int(env._early_termination_step_threshold)
        self.resample_step = int(env._resample_velocity_step)
        rewards = env._reward_config["rewards"]
        self.sigma = float(rewards["tracking_sigma"])
        self.scales = {k: float(rewards["scales"][k]) for k in REWARD_ORDER}
        self.desired_abduction = [float(x) for x in host["desired_abduction_angles"]]
        self.ss_thresh = float(env._stand_still_command_threshold)
        upper_geoms = set(int(g) for g in env._upper_leg_geom_ids)
        torso_geoms = set(int(g) for g in env._torso_geom_ids)
        self.knee_pairs = [
            i for i, p in enumerate(s.pairs)
            if p.geom1 in upper_geoms or p.geom2 in upper_geoms
        ]
        self.body_pairs = [
            i for i, p in enumerate(s.pairs)
            if p.geom1 in torso_geoms or p.geom2 in torso_geoms
        ]

        # the privileged (critic-only) rows, emitted in the wrapped step's
        # aux block (K3, K4; the standard lane computes them in torch,
        # ``PupperV3Env._privileged_observation``). The kernel reads the
        # friction leaf from pair_mu[0], the larger slide friction of pair
        # 0's geoms: DR sets one scalar on every geom, so that equals
        # geom_friction[0, 0]. A model whose base frictions do not give that
        # equality, or that has no pair, keeps priv off, and with it the
        # standard lane (``rollout.support_reason``).
        self.priv = bool(getattr(env, "_privileged_obs", False))
        if self.priv:
            gf = np.asarray(env.model.geom_friction)[..., 0]
            if len(s.pairs) == 0:
                self.priv = False
            else:
                p0 = s.pairs[0]
                if gf.ndim != 1 or not np.isclose(max(gf[p0.geom1], gf[p0.geom2]), gf[0]):
                    self.priv = False
        self.npriv = int(env.privileged_obs_size) if self.priv else 0

        self.env_rows: Dict[str, Tuple[int, int]] = {}
        r = 0
        for name, n in (
            ("action_buffer", 12 * self.Da),
            ("imu_buffer", 6 * self.Di),
            ("command", 3),
            ("desired_z", 3),
            ("last_act", 12),
            ("last_vel", 12),
            ("feet_air_time", 4),
            ("last_contact", 4),
            ("step", 1),
            ("obs_history", self.hist),
        ):
            self.env_rows[name] = (r, n)
            r += n
        self.nenv_rows = r

        self.noise_rows: Dict[str, Tuple[int, int]] = {}
        r = 0
        for name, n in (
            ("kick", 2),
            ("act_lat", self.Da),
            ("imu_lat", self.Di),
            ("ang_vel_noise", 3),
            ("gravity_noise", 3),
            ("motor_ang_noise", 12),
            ("last_action_noise", 12),
            ("resample_cmd", 3),
            ("resample_ori", 3),
        ):
            self.noise_rows[name] = (r, n)
            r += n
        self.nnoise_rows = r


TWO_PI = 2.0 * np.pi


def tick_gait_clock(phase: torch.Tensor, dphase: float, done=None) -> torch.Tensor:
    """The gait clock's tick, ``fmod(phase + dphase, 2 pi)`` in float32
    (``pupper.py:761-765``; the phase is never negative, so ``fmod`` is
    ``jnp.mod``), restarted at 0 where ``done > 0.5`` when ``done`` is
    given (the AutoReset restart, ``wrappers.py:151-162``)."""
    ticked = torch.fmod(phase + dphase, TWO_PI)
    return ticked if done is None else torch.where(done > 0.5, torch.zeros_like(phase), ticked)


def host_consts_from_args(**kw) -> Dict[str, np.ndarray]:
    """Env constructor constants as float64 numpy arrays."""
    out = {}
    for k, v in kw.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, np.float64)
    return out


def rows_block(parts: List[torch.Tensor]) -> torch.Tensor:
    """(B, ...) tensors -> one ``(rows, B)`` row-major float32 block."""
    B = parts[0].shape[0]
    return torch.cat([x.to(torch.float32).reshape(B, -1) for x in parts], 1).t().contiguous()


def env_block(es: _EnvStatic, info: Dict, obs: torch.Tensor) -> torch.Tensor:
    """A State's info fields and observation history as the
    ``(nenv_rows, B)`` env-row block both kernels read (``es.env_rows``)."""
    fields = {
        "action_buffer": info["action_buffer"],
        "imu_buffer": info["imu_buffer"],
        "command": info["command"],
        "desired_z": info["desired_world_z_in_body_frame"],
        "last_act": info["last_act"],
        "last_vel": info["last_vel"],
        "feet_air_time": info["feet_air_time"],
        "last_contact": info["last_contact"],
        "step": info["step"],
        "obs_history": obs[:, : es.hist],
    }
    return rows_block([fields[name] for name in es.env_rows])


def noise_block(es: _EnvStatic, noise: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A ``draw_step_noise`` dict of (B, n) draws as the ``(nnoise_rows, B)``
    block."""
    return rows_block([noise[name] for name in es.noise_rows])


def aux_row_map(es: _EnvStatic) -> Dict[str, Tuple[int, int]]:
    """Row map of the wrapped step's aux output block (the privileged rows
    last, where the env has them)."""
    out: Dict[str, Tuple[int, int]] = {}
    r = 0
    names = [("reward", 1), ("done", 1), ("truncation", 1), ("rewards", len(REWARD_ORDER)),
             ("total_dist", 1)]
    if es.priv:
        names.append(("privileged", es.npriv))
    for name, n in names:
        out[name] = (r, n)
        r += n
    return out
