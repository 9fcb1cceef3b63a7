"""PupperV3 joystick-locomotion environment, batched over envs.

Counterpart of ``puppax/env/pupper.py``: the constructor surface, the
observation layout, ``reset``, the per-step noise draws and ``step``.
Every random draw comes from the envs' jax keys (``refport.random``,
``(B, 2)``, one per env, carried in ``info["rng"]``) in the JAX env's split
and draw order, so a reset or step from the same keys makes the same
draws. The draws stay apart from the deterministic math (``draw_reset`` /
``reset_from_draws``, ``draw_step_noise`` / ``step_from_draws``), so tests
can also feed given numbers to this env and to the JAX one.

``step`` is the physics-only lane: the env layer as torch ops
(``_step_core``: kick, action latency, motor targets, observation,
contacts, termination, the 18 rewards of ``env/rewards.py``) around one
physics step through ``pipeline.make_batched_step`` (``pipeline_step`` in
the state's dtype). The info epilogue runs in PyTorch, and with it the
gait clock (``gait_phase_observation``): ``info["gait_phase"]`` ticks by
the float32 ``2 pi f dt`` modulo 2 pi each step and its (cos, sin) follow
the history stack in the observation.

With ``privileged_obs`` the env publishes ``info["privileged_obs"]``
(``_privileged_observation``, torch ops at reset and after each step; the
fast lane's kernels emit the same rows), the critic's view of the true
state; with ``disturbance_curriculum``, ``info["difficulty"]`` (1 at
reset) scales the step's disturbance draws (``scale_disturbances``).

Reset needs only the root's FK: the reset observation reads the torso
rotation and a zero angular velocity (``smooth.kinematics``).
``pipeline_init`` runs the full pass (``pipeline.pipeline_init``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from refport import random, utils
from refport.configs.experiment import EnvConfig, StartPositionConfig
from refport.env import domain_randomization, rewards, soa_env
from refport.env.base import PhysicsState, State
from refport.model.mjcf import config_tables_path, load_model
from refport.ops import math
from refport.physics import pipeline, smooth, soa


# the step's draws the disturbance curriculum scales (pupper.py:692-700)
DISTURBANCE_KEYS = ("kick", "ang_vel_noise", "gravity_noise", "motor_ang_noise",
                    "last_action_noise")


def scale_disturbances(noise: Dict[str, torch.Tensor], difficulty) -> Dict[str, torch.Tensor]:
    """``noise`` with its disturbance draws (``DISTURBANCE_KEYS``) times
    ``difficulty`` (broadcast against each draw), the others as they are."""
    return {k: v * difficulty if k in DISTURBANCE_KEYS else v for k, v in noise.items()}


class PupperV3Env:
    """Pupper v3 joystick policy training environment (batched)."""

    # noise rows the step consumes (puppax PupperV3Env._CORE_NOISE_KEYS)
    _CORE_NOISE_KEYS = (
        "kick", "act_lat", "imu_lat", "ang_vel_noise", "gravity_noise",
        "motor_ang_noise", "last_action_noise", "resample_cmd", "resample_ori",
    )

    def __init__(
        self,
        path: Optional[str] = None,
        reward_config: Dict = None,
        action_scale: float = 0.75,
        observation_history: int = 2,
        joint_lower_limits: List = (
            -1.220, -0.420, -2.790, -2.510, -3.140, -0.710,
            -1.220, -0.420, -2.790, -2.510, -3.140, -0.710,
        ),
        joint_upper_limits: List = (
            2.510, 3.140, 0.710, 1.220, 0.420, 2.790,
            2.510, 3.140, 0.710, 1.220, 0.420, 2.790,
        ),
        dof_damping: float = 0.25,
        position_control_kp: float = 5.0,
        start_position_config: StartPositionConfig = StartPositionConfig(),
        foot_site_names: List[str] = (
            "leg_front_r_3_foot_site",
            "leg_front_l_3_foot_site",
            "leg_back_r_3_foot_site",
            "leg_back_l_3_foot_site",
        ),
        torso_name: str = "base_link",
        upper_leg_body_names: List[str] = (
            "leg_front_r_2", "leg_front_l_2", "leg_back_r_2", "leg_back_l_2",
        ),
        lower_leg_body_names: List[str] = (
            "leg_front_r_3", "leg_front_l_3", "leg_back_r_3", "leg_back_l_3",
        ),
        resample_velocity_step: int = 500,
        linear_velocity_x_range: Tuple[float, float] = (-0.75, 0.75),
        linear_velocity_y_range: Tuple[float, float] = (-0.5, 0.5),
        angular_velocity_range: Tuple[float, float] = (-2.0, 2.0),
        zero_command_probability: float = 0.01,
        stand_still_command_threshold: float = 0.1,
        maximum_pitch_command: float = 0.0,  # degrees
        maximum_roll_command: float = 0.0,  # degrees
        default_pose=None,
        desired_abduction_angles=None,
        angular_velocity_noise: float = 0.3,
        gravity_noise: float = 0.1,
        motor_angle_noise: float = 0.1,
        last_action_noise: float = 0.01,
        kick_vel: float = 0.2,
        kick_probability: float = 0.02,
        terminal_body_z: float = 0.1,
        early_termination_step_threshold: int = 500,
        terminal_body_angle: float = 0.52,
        foot_radius: float = 0.02,
        environment_timestep: float = 0.02,
        physics_timestep: float = 0.004,
        latency_distribution=None,
        imu_latency_distribution=None,
        desired_world_z_in_body_frame=None,
        use_imu: bool = True,
        privileged_obs: bool = False,
        gait_phase_observation: bool = False,
        gait_frequency: float = 2.5,
        disturbance_curriculum: bool = False,
        device=None,
        tables: Optional[str] = None,
    ):
        if path is not None and tables is None:
            # another MJCF, as it is: its committed tables (config_tables_path
            # raises, naming the writer, where they are missing)
            tables = config_tables_path(EnvConfig(path=path))
        if default_pose is None:
            default_pose = np.array(
                [0.26, 0.0, -0.52, -0.26, 0.0, 0.52, 0.26, 0.0, -0.52, -0.26, 0.0, 0.52]
            )
        if desired_abduction_angles is None:
            desired_abduction_angles = np.array([0.0, 0.0, 0.0, 0.0])
        if latency_distribution is None:
            latency_distribution = np.array([0.2, 0.8])
        if imu_latency_distribution is None:
            imu_latency_distribution = np.array([0.5, 0.5])
        if desired_world_z_in_body_frame is None:
            desired_world_z_in_body_frame = np.array([0.0, 0.0, 1.0])
        if reward_config is None:
            from refport.configs.rewards import get_config

            reward_config = get_config()
        self.device = utils.resolve_device(device)

        host = soa_env.host_consts_from_args(
            default_pose=default_pose,
            desired_abduction_angles=desired_abduction_angles,
            latency_distribution=latency_distribution,
            imu_latency_distribution=imu_latency_distribution,
            joint_lower_limits=joint_lower_limits,
            joint_upper_limits=joint_upper_limits,
            action_scale=action_scale,
        )

        # the model's committed tables: the bundled flat model's by default,
        # another MJCF's (path) or a terrain's from from_config
        # (mjcf.config_tables_path)
        compiled = load_model() if tables is None else load_model(tables)
        model = compiled.robot.tree_replace({"opt.timestep": physics_timestep})
        # actuator override: PD with kp/kd
        gainprm = np.array(model.actuator_gainprm)
        gainprm[:, 0] = position_control_kp
        biasprm = np.array(model.actuator_biasprm)
        biasprm[:, 1] = -position_control_kp
        biasprm[:, 2] = -dof_damping
        model = model.replace(actuator_gainprm=gainprm, actuator_biasprm=biasprm)
        self._dt = environment_timestep
        self._n_substeps = int(environment_timestep / physics_timestep)

        init_q = np.array(model.key_qpos)
        init_q[7:] = np.asarray(default_pose, np.float32)
        model = model.replace(key_qpos=init_q)
        self.model = model

        f32 = np.float32
        self._reward_config = reward_config
        self._torso_geom_ids = compiled.body_geom_ids(torso_name)
        self._torso_idx = compiled.body_id(torso_name)
        self._angular_velocity_noise = angular_velocity_noise
        self._gravity_noise = gravity_noise
        self._motor_angle_noise = motor_angle_noise
        self._last_action_noise = last_action_noise
        self._kick_vel = kick_vel
        self._init_q = init_q
        self._default_pose = np.asarray(default_pose, f32)
        self._feet_site_id = np.array([compiled.site_id(n) for n in foot_site_names])
        self._lower_leg_body_id = np.array(
            [compiled.body_id(n) for n in lower_leg_body_names]
        )
        self._upper_leg_geom_ids = np.concatenate(
            [compiled.body_geom_ids(n) for n in upper_leg_body_names]
        )
        self._foot_radius = foot_radius
        self._nv = model.nv
        self._start_position_config = start_position_config
        self._linear_velocity_x_range = linear_velocity_x_range
        self._linear_velocity_y_range = linear_velocity_y_range
        self._angular_velocity_range = angular_velocity_range
        self._zero_command_probability = zero_command_probability
        self._stand_still_command_threshold = stand_still_command_threshold
        self._maximum_pitch_command = maximum_pitch_command
        self._maximum_roll_command = maximum_roll_command
        self._kick_probability = kick_probability
        self._resample_velocity_step = resample_velocity_step
        self.observation_dim = 36
        self._observation_history = observation_history
        self._early_termination_step_threshold = early_termination_step_threshold
        self._terminal_body_z = terminal_body_z
        self._terminal_body_angle = terminal_body_angle
        self._cos_terminal_angle = float(torch.cos(torch.tensor(terminal_body_angle,
                                                                dtype=torch.float32)))
        self._desired_world_z_in_body_frame = np.asarray(desired_world_z_in_body_frame, f32)
        self._latency_distribution = np.asarray(latency_distribution, f32)
        self._imu_latency_distribution = np.asarray(imu_latency_distribution, f32)
        self._use_imu = use_imu
        self._privileged_obs = privileged_obs
        self._disturbance_curriculum = disturbance_curriculum
        self._gait_phase_obs = gait_phase_observation
        self._gait_frequency = gait_frequency
        # the clock's tick in float32, as the JAX env rounds it
        self._dphase = float(f32(2.0 * np.pi * gait_frequency * environment_timestep))
        self._desired_abduction_angles = np.asarray(desired_abduction_angles, f32)
        self.lowers = np.asarray(joint_lower_limits, f32)
        self.uppers = np.asarray(joint_upper_limits, f32)

        # the emission's static digests (the JAX env's _cv_core._s / ._es)
        self._s = soa._Static(model, compiled.mj)
        self._es = soa_env._EnvStatic(host, self, self._s)
        self._cv_step = pipeline.make_batched_step(model, self._n_substeps, compiled.mj)
        statics = pipeline.pair_contact_statics(model, compiled.mj, device=self.device)
        self._pair_geom1, self._pair_geom2 = statics["geom1"], statics["geom2"]
        # constants of the step on the device once: a host-to-device copy
        # from pageable memory waits for the stream
        self._dev = {name: self._t(x) for name, x in (
            ("default_pose", self._default_pose), ("lowers", self.lowers),
            ("uppers", self.uppers), ("desired_abduction", self._desired_abduction_angles),
            ("up", [0.0, 0.0, 1.0]), ("down", [0.0, 0.0, -1.0]),
            ("identity_quat", [1.0, 0.0, 0.0, 0.0]),
            ("desired_z", self._desired_world_z_in_body_frame),
        )}
        self._dev["upper_leg_geoms"] = self._geom_ids(self._upper_leg_geom_ids)
        self._dev["torso_geoms"] = self._geom_ids(self._torso_geom_ids)
        self._dev["feet_sites"] = self._geom_ids(self._feet_site_id)
        self._dev["lower_legs"] = self._geom_ids(self._lower_leg_body_id)

    @classmethod
    def from_config(cls, cfg: EnvConfig, reward_config: Dict = None, device=None):
        """The env of an ``EnvConfig``: the flat model, or its MJCF
        (``env.path``) and its terrain (obstacles, a heightfield, or both)
        from the committed tables (``mjcf.config_tables_path``, which raises
        for a model without them)."""
        tables = config_tables_path(cfg)
        kw = {
            k: getattr(cfg, k)
            for k in (
                "action_scale", "observation_history", "dof_damping",
                "position_control_kp", "resample_velocity_step",
                "linear_velocity_x_range", "linear_velocity_y_range",
                "angular_velocity_range", "zero_command_probability",
                "stand_still_command_threshold", "maximum_pitch_command",
                "maximum_roll_command", "angular_velocity_noise",
                "gravity_noise", "motor_angle_noise", "last_action_noise",
                "kick_vel", "kick_probability", "terminal_body_z",
                "early_termination_step_threshold", "terminal_body_angle",
                "foot_radius", "environment_timestep", "physics_timestep",
                "use_imu", "privileged_obs", "gait_phase_observation",
                "gait_frequency", "disturbance_curriculum",
            )
        }
        return cls(reward_config=reward_config, start_position_config=cfg.start_position,
                   device=device, tables=tables, **kw)

    # ---- properties -----------------------------------------------------
    @property
    def dt(self) -> float:
        return self._dt

    @property
    def observation_size(self) -> int:
        """The stacked observation history, plus the gait clock (cos, sin)
        after it when the clock is on."""
        n = self.observation_dim * self._observation_history
        return n + 2 if self._gait_phase_obs else n

    @property
    def action_size(self) -> int:
        return self.model.nu

    @property
    def privileged_obs_size(self) -> int:
        """34: the torso's true local linear and angular velocity and gravity
        (9), the joint velocities (12), the contact flags (4), the feet air
        times (4), the kick (2) and the DR leaves friction, kp and torso
        mass (3)."""
        return 34

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    # ---- random draws -----------------------------------------------------
    # Each draw takes (B, 2) per-env keys and makes the JAX env's draws for
    # every env in its split and draw order, as jax.vmap over the keys would
    # (``pupper.py:333-367, 382-386, 440-498``).
    def sample_command(self, keys: torch.Tensor) -> torch.Tensor:
        """(B, 3) commands (vx, vy, wz); with probability
        zero_command_probability a near-zero command instead."""
        k = random.split(keys, 6)
        vx = random.uniform(k[:, 1], (1,), *self._linear_velocity_x_range)
        vy = random.uniform(k[:, 2], (1,), *self._linear_velocity_y_range)
        wz = random.uniform(k[:, 3], (1,), *self._angular_velocity_range)
        new_cmd = torch.cat([vx, vy, wz], -1)
        zero_p = random.uniform(k[:, 4], (1,))
        t = self._stand_still_command_threshold
        near_zero = random.uniform(k[:, 5], (3,), -t, t)
        return torch.where(zero_p < float(np.float32(self._zero_command_probability)),
                           near_zero, new_cmd)

    def sample_body_orientation(self, keys: torch.Tensor) -> torch.Tensor:
        """(B, 3) desired world-z rotated by random pitch/roll (degrees)."""
        k = random.split(keys, 3)
        pitch = random.uniform(k[:, 1], (1,), -1.0, 1.0)[:, 0] * self._maximum_pitch_command
        roll = random.uniform(k[:, 2], (1,), -1.0, 1.0)[:, 0] * self._maximum_roll_command
        euler = torch.stack([roll, pitch, torch.zeros_like(roll)], -1)
        return math.rotate(self._dev["desired_z"],
                           math.euler_to_quat(euler))

    def _draw_obs_noise(self, keys: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The observation's draws (``pupper.py:464-482``); "rng" is the
        carried key."""
        k = random.split(keys, 6)

        def pm1(i, n, scale):
            return random.uniform(k[:, i], (n,), -1.0, 1.0) * scale

        return {
            "rng": k[:, 0],
            "ang_vel_noise": pm1(1, 3, self._angular_velocity_noise),
            "gravity_noise": pm1(2, 3, self._gravity_noise),
            "motor_ang_noise": pm1(3, 12, self._motor_angle_noise),
            "last_action_noise": pm1(4, 12, self._last_action_noise),
            "imu_lat": utils.latency_onehot(k[:, 5], self._imu_latency_distribution),
        }

    def draw_step_noise(self, keys: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every random draw one env step makes from the envs' ``(B, 2)``
        keys, as (B, n) rows, and "rng", the keys carried to the next step
        (``_draw_step_noise``; the resample command and orientation share
        one key, as there)."""
        k = random.split(keys, 5)
        kick = random.uniform(k[:, 2], (2,), -1.0, 1.0) * self._kick_vel
        kick = kick * random.bernoulli(k[:, 3], self._kick_probability, (1,))
        noise = {
            "kick": kick,
            "act_lat": utils.latency_onehot(k[:, 4], self._latency_distribution),
        }
        noise.update(self._draw_obs_noise(k[:, 0]))
        noise["resample_cmd"] = self.sample_command(k[:, 1])
        noise["resample_ori"] = self.sample_body_orientation(k[:, 1])
        return noise

    def draw_reset(self, keys: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every random draw ``reset`` makes from the envs' ``(B, 2)`` keys:
        start qpos, command, desired orientation, the reset observation's
        noise and "rng", the keys the state carries (``pupper.py:382-386``)."""
        keys = keys.to(self.device)
        k = random.split(keys, 4)
        draws = {
            "qpos": domain_randomization.randomize_qpos(
                self._init_q, self._start_position_config, k[:, 3]
            ),
            "command": self.sample_command(k[:, 1]),
            "desired_z": self.sample_body_orientation(k[:, 2]),
        }
        draws.update(self._draw_obs_noise(k[:, 0]))
        return draws

    # ---- reset ----------------------------------------------------------------
    def reset(self, keys: torch.Tensor) -> State:
        """Reset one env per key of ``keys`` ``(B, 2)``."""
        return self.reset_from_draws(self.draw_reset(keys))

    def reset_from_draws(self, draws: Dict[str, torch.Tensor], model=None) -> State:
        """The deterministic reset core (``pupper.py:382-438``) on given
        draws; ``model`` (default: this env's) gives the privileged obs its
        DR leaves."""
        qpos = draws["qpos"].to(self.device, torch.float32)
        B = qpos.shape[0]
        zeros = lambda *shape: torch.zeros((B,) + shape, device=self.device)  # noqa: E731
        # root FK only: the torso rotation
        m = pipeline.model_tensors(self.model, torch.float64, self.device)
        torso_quat = smooth.kinematics(m, qpos.double()).xquat[:, self._torso_idx].float()
        imu_buffer = zeros(6, len(self._imu_latency_distribution))
        imu_buffer[:, 5, :] = -1.0
        info = {
            "last_act": zeros(12),
            "action_buffer": zeros(12, len(self._latency_distribution)),
            "imu_buffer": imu_buffer,
            "last_vel": zeros(12),
            "command": draws["command"].to(self.device, torch.float32),
            "last_contact": torch.zeros((B, 4), dtype=torch.bool, device=self.device),
            "feet_air_time": zeros(4),
            "rewards": {k: zeros() for k in self._reward_config["rewards"]["scales"]},
            "kick": zeros(2),
            "step": torch.zeros(B, dtype=torch.int32, device=self.device),
            "desired_world_z_in_body_frame": draws["desired_z"].to(self.device, torch.float32),
        }
        if "rng" in draws:
            info["rng"] = draws["rng"].to(self.device)
        if self._privileged_obs:
            # at rest: no velocity, no contact, no air time, no kick
            info["privileged_obs"] = self._privileged_observation(
                self.model if model is None else model, torso_quat, zeros(3), zeros(3),
                zeros(12), info, info["kick"])
        if self._disturbance_curriculum:
            # the disturbance scale in [0, 1] of the step's kick and
            # observation noise; full by default, ramped by ppo.train
            info["difficulty"] = torch.ones(B, device=self.device)
        obs = self._get_obs(qpos, torso_quat, zeros(3), info, draws,
                            zeros(self._es.hist))
        if self._gait_phase_obs:
            info["gait_phase"] = zeros()
            obs = torch.cat([obs, torch.ones_like(obs[:, :1]), zeros(1)], -1)  # cos 0, sin 0
        metrics = {"total_dist": zeros()}
        metrics.update({k: v for k, v in info["rewards"].items()})
        return State(qpos=qpos, qvel=zeros(self._nv), obs=obs, reward=zeros(),
                     done=zeros(), metrics=metrics, info=info)

    def dr_rows(self, B: int, model=None) -> torch.Tensor:
        """The ``(ndr, B)`` per-env parameter rows of ``model`` (default:
        this env's model); an unbatched model is broadcast over the envs."""
        m = self.model if model is None else model
        return soa.dr_rows_block(self._s, soa.dr_inputs(m, self._s, B, device=self.device))

    def pipeline_init(self, qpos: torch.Tensor, qvel: torch.Tensor,
                      model=None) -> PhysicsState:
        """The reset-time physics state (``pipeline.pipeline_init``: one
        forward pass at zero controls) of ``model`` (default: this env's
        model; a DR-batched one carries one row per env)."""
        return pipeline.pipeline_init(self.model if model is None else model, qpos, qvel)

    # ---- step -----------------------------------------------------------------
    def step(self, state: State, action: torch.Tensor,
             dr_rows: Optional[torch.Tensor] = None, model=None) -> State:
        """One env step of every env, its draws made from ``info["rng"]``,
        which carries on to the next step."""
        noise = self.draw_step_noise(state.info["rng"])
        return self.step_from_draws(state, action, noise, dr_rows, model)

    def step_from_draws(self, state: State, action: torch.Tensor,
                        noise: Dict[str, torch.Tensor],
                        dr_rows: Optional[torch.Tensor] = None, model=None) -> State:
        """The env step (``pupper.py:684-780``) on given draws through
        ``_step_core``, then the info epilogue. ``model`` is the
        (DR-batched) model, None this env's model, broadcast; ``dr_rows``
        (the kernels' parameter rows) is not read."""
        es = self._es
        info = dict(state.info)
        if self._disturbance_curriculum:
            # the difficulty scales the disturbance draws outside the step
            # core (``pupper.py:692-700``); at 1 the step is the plain env's
            noise = scale_disturbances(noise, info["difficulty"][:, None])
        env_in = {
            "action_buffer": info["action_buffer"],
            "imu_buffer": info["imu_buffer"],
            "command": info["command"],
            "desired_z": info["desired_world_z_in_body_frame"],
            "last_act": info["last_act"],
            "last_vel": info["last_vel"],
            "feet_air_time": info["feet_air_time"],
            "last_contact": info["last_contact"],
            "step": info["step"],
            "obs_history": state.obs[:, : es.hist],
        }
        m = self.model if model is None else model
        pipeline_state, env_out = self._step_core(m, state.qpos, state.qvel, action,
                                                  env_in, noise, dr_rows)
        info["kick"] = noise["kick"]
        if "rng" in noise:
            info["rng"] = noise["rng"]
        info["last_act"] = action
        info["last_vel"] = pipeline_state.qvel[:, 6:]
        for name in ("action_buffer", "imu_buffer", "feet_air_time", "last_contact",
                     "rewards", "step", "command"):
            info[name] = env_out[name]
        info["desired_world_z_in_body_frame"] = env_out["desired_z"]
        if self._privileged_obs:
            t = self._torso_idx - 1
            info["privileged_obs"] = self._privileged_observation(
                self.model if model is None else model, pipeline_state.x_rot[:, t],
                pipeline_state.xd_vel[:, t], pipeline_state.xd_ang[:, t],
                pipeline_state.qvel[:, 6:], info, noise["kick"])
        obs = env_out["obs"]
        if self._gait_phase_obs:
            # the clock runs outside the step core (pupper.py:754-767); the
            # wrappers restart it on the effective done
            phase = soa_env.tick_gait_clock(info["gait_phase"], self._dphase)
            info["gait_phase"] = phase
            obs = torch.cat([obs, torch.cos(phase)[:, None], torch.sin(phase)[:, None]], -1)
        metrics = dict(state.metrics)
        metrics["total_dist"] = env_out["total_dist"]
        metrics.update(env_out["rewards"])
        return state.replace(
            qpos=pipeline_state.qpos, qvel=pipeline_state.qvel, obs=obs,
            reward=env_out["reward"], done=env_out["done"], metrics=metrics, info=info,
            pipeline_state=pipeline_state,
        )

    def _step_core(self, m, qpos: torch.Tensor, qvel: torch.Tensor, action: torch.Tensor,
                   env_in: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor],
                   dr_rows: Optional[torch.Tensor] = None):
        """The deterministic env step core of the physics-only lane
        (``pupper.py:507-682``), batched: noise in, (PhysicsState, env_out)
        out. The physics is one ``_cv_pipeline_step``."""
        # random kick
        qvel = torch.cat([noise["kick"] + qvel[:, :2], qvel[:, 2:]], -1)
        # action latency
        lagged_action, action_buffer = utils.apply_lagged_value(
            env_in["action_buffer"], action, noise["act_lat"])
        # physics
        c = self._dev
        lowers, uppers = c["lowers"], c["uppers"]
        motor_targets = c["default_pose"] + lagged_action * self._es.action_scale
        motor_targets = torch.minimum(torch.maximum(motor_targets, lowers), uppers)
        ps = self._cv_pipeline_step(m, qpos, qvel, motor_targets, dr_rows)

        obs_info = {
            "command": env_in["command"],
            "desired_world_z_in_body_frame": env_in["desired_z"],
            "imu_buffer": env_in["imu_buffer"],
            "last_act": env_in["last_act"],
        }
        obs = self._get_obs(ps.qpos, ps.x_rot[:, 0], ps.xd_ang[:, 0], obs_info, noise,
                            env_in["obs_history"])
        joint_angles, joint_vel = ps.qpos[:, 7:], ps.qvel[:, 6:]

        # foot contact from the site heights
        foot_contact_z = ps.site_xpos[:, c["feet_sites"], 2] - self._foot_radius
        contact = foot_contact_z < 1e-3
        contact_filt_mm = contact | env_in["last_contact"]
        contact_filt_cm = (foot_contact_z < 3e-2) | env_in["last_contact"]
        first_contact = (env_in["feet_air_time"] > 0) & contact_filt_mm
        feet_air_time = env_in["feet_air_time"] + self.dt

        # termination
        torso = self._torso_idx - 1
        done = math.rotate(c["up"], ps.x_rot[:, torso])[:, 2] < self._cos_terminal_angle
        done = done | torch.any(joint_angles < lowers, -1)
        done = done | torch.any(joint_angles > uppers, -1)
        done = done | (ps.x_pos[:, torso, 2] < self._terminal_body_z)

        # rewards, in the JAX step core's (and K2's) order
        cfg = self._reward_config["rewards"]
        sigma, cmd = cfg["tracking_sigma"], env_in["command"]
        terms = {
            "tracking_lin_vel": rewards.reward_tracking_lin_vel(cmd, ps, sigma),
            "tracking_ang_vel": rewards.reward_tracking_ang_vel(cmd, ps, sigma),
            "tracking_orientation": rewards.reward_tracking_orientation(
                env_in["desired_z"], ps, sigma),
            "lin_vel_z": rewards.reward_lin_vel_z(ps),
            "ang_vel_xy": rewards.reward_ang_vel_xy(ps),
            "orientation": rewards.reward_orientation(ps),
            "torques": rewards.reward_torques(ps.qfrc_actuator),
            "joint_acceleration": rewards.reward_joint_acceleration(
                joint_vel, env_in["last_vel"], dt=self._dt),
            "mechanical_work": rewards.reward_mechanical_work(ps.qfrc_actuator[:, 6:],
                                                              ps.qvel[:, 6:]),
            "action_rate": rewards.reward_action_rate(action, env_in["last_act"]),
            "stand_still": rewards.reward_stand_still(cmd, joint_angles,
                                                      c["default_pose"], 0.1),
            "stand_still_joint_velocity": rewards.reward_stand_still(
                cmd, joint_vel, torch.zeros_like(joint_vel),
                self._stand_still_command_threshold),
            "abduction_angle": rewards.reward_abduction_angle(
                joint_angles, c["desired_abduction"]),
            "feet_air_time": rewards.reward_feet_air_time(feet_air_time, first_contact, cmd),
            "foot_slip": rewards.reward_foot_slip(ps, contact_filt_cm, c["feet_sites"],
                                                  c["lower_legs"]),
            "termination": rewards.reward_termination(
                done, env_in["step"], self._early_termination_step_threshold),
            "knee_collision": rewards.reward_geom_collision(
                ps, c["upper_leg_geoms"], self._pair_geom1, self._pair_geom2),
            "body_collision": rewards.reward_geom_collision(
                ps, c["torso_geoms"], self._pair_geom1, self._pair_geom2),
        }
        terms = {k: v * cfg["scales"][k] for k, v in terms.items()}
        reward = torch.clamp(sum(terms.values()) * self.dt, 0.0, 10000.0)

        # carried-field updates and the command + orientation resample
        feet_air_time = feet_air_time * ~contact_filt_mm
        step_count = env_in["step"] + 1
        resample = step_count > self._resample_velocity_step
        command = torch.where(resample[:, None], noise["resample_cmd"], cmd)
        desired_z = torch.where(resample[:, None], noise["resample_ori"], env_in["desired_z"])
        step_count = torch.where(done | resample, torch.zeros_like(step_count), step_count)
        return ps, {
            "obs": obs,
            "reward": reward,
            "done": done.to(torch.float32),
            "action_buffer": action_buffer,
            "imu_buffer": obs_info["imu_buffer"],
            "command": command,
            "desired_z": desired_z,
            "feet_air_time": feet_air_time,
            "last_contact": contact,
            "step": step_count,
            "rewards": terms,
            "total_dist": math.normalize(ps.x_pos[:, torso])[1],
        }

    def _privileged_observation(self, m, torso_quat, torso_vel, torso_ang, joint_vel, info,
                                kick) -> torch.Tensor:
        """The critic-only observation (``pupper.py:298-331``): the torso's
        un-noised, un-lagged local velocities and gravity, the joint
        velocities, ``info``'s contact flags and feet air times, the kick,
        and the DR leaves of ``m`` (``geom_friction[0, 0]``,
        ``actuator_gainprm[0, 0]``, the torso's ``body_mass``), (B, 34)."""
        inv_rot = math.quat_inv(torso_quat)
        B = torso_quat.shape[0]
        dtype = torso_quat.dtype
        leaves = [m.geom_friction[..., 0, 0], m.actuator_gainprm[..., 0, 0],
                  m.body_mass[..., self._torso_idx]]
        dr = torch.stack([torch.as_tensor(x, device=self.device).to(dtype).expand(B)
                          for x in leaves], -1)
        return torch.cat([
            math.rotate(torso_vel, inv_rot),
            math.rotate(torso_ang, inv_rot),
            math.rotate(self._dev["down"].to(dtype), inv_rot),
            joint_vel,
            info["last_contact"].to(dtype),
            info["feet_air_time"].to(dtype),
            kick.to(dtype),
            dr,
        ], -1)

    def _geom_ids(self, ids) -> torch.Tensor:
        """Static ids (geoms, sites, bodies) as an int64 tensor on the device."""
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=self.device)

    def _cv_pipeline_step(self, m, qpos: torch.Tensor, qvel: torch.Tensor,
                          motor_targets: torch.Tensor,
                          dr_rows: Optional[torch.Tensor] = None) -> PhysicsState:
        """One env step's physics through ``pipeline.make_batched_step``
        (``pipeline_step`` in the state's dtype). The
        per-pair contact metadata that the JAX env re-attaches to the tuple
        (``_ps_from_tuple``) stays with the env: ``_pair_geom1`` and
        ``_pair_geom2`` are what the collision rewards read."""
        return PhysicsState(*self._cv_step(m, qpos, qvel, motor_targets, dr_rows))

    def _get_obs(self, qpos, torso_quat, torso_ang_vel, info, noise, obs_history):
        """36-dim observation, noised/lagged, stacked newest-first; updates
        ``info["imu_buffer"]``."""
        if self._use_imu:
            inv_torso_rot = math.quat_inv(torso_quat)
            local_ang_vel = math.rotate(torso_ang_vel, inv_torso_rot)
        else:
            inv_torso_rot = self._dev["identity_quat"].expand_as(torso_quat)
            local_ang_vel = torch.zeros_like(torso_ang_vel)
        gravity = math.rotate(self._dev["down"], inv_torso_rot)
        gravity = gravity + noise["gravity_noise"]
        gravity = gravity / torch.linalg.vector_norm(gravity, dim=-1, keepdim=True)
        imu = torch.cat([local_ang_vel + noise["ang_vel_noise"], gravity], -1)
        lagged, info["imu_buffer"] = utils.apply_lagged_value(
            info["imu_buffer"], imu, noise["imu_lat"]
        )
        obs = torch.cat(
            [
                lagged,
                info["command"],
                info["desired_world_z_in_body_frame"],
                qpos[:, 7:] - self._dev["default_pose"] + noise["motor_ang_noise"],
                info["last_act"] + noise["last_action_noise"],
            ],
            -1,
        )
        obs = torch.clamp(obs, -100.0, 100.0)
        n = obs.shape[-1]
        return torch.cat([obs, obs_history[:, : obs_history.shape[-1] - n]], -1)
