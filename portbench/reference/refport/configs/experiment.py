"""Frozen experiment config: env / domain randomization / train defaults.

Counterpart of ``puppax/configs/experiment.py``: the same fields, the same
defaults, the dict/JSON round trip, dotted-path overrides and the config
hash (equal to the JAX package's for the same config).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class StartPositionConfig:
    x_min: float = -2.0
    x_max: float = 2.0
    y_min: float = -2.0
    y_max: float = 2.0
    z_min: float = 0.15
    z_max: float = 0.20


@dataclass(frozen=True)
class EnvConfig:
    """PupperV3Env construction defaults."""

    path: Optional[str] = None  # None = bundled Pupper v3 tables
    action_scale: float = 0.75
    observation_history: int = 2
    dof_damping: float = 0.25
    position_control_kp: float = 5.0
    resample_velocity_step: int = 500
    linear_velocity_x_range: Tuple[float, float] = (-0.75, 0.75)
    linear_velocity_y_range: Tuple[float, float] = (-0.5, 0.5)
    angular_velocity_range: Tuple[float, float] = (-2.0, 2.0)
    zero_command_probability: float = 0.01
    stand_still_command_threshold: float = 0.1
    maximum_pitch_command: float = 0.0
    maximum_roll_command: float = 0.0
    angular_velocity_noise: float = 0.3
    gravity_noise: float = 0.1
    motor_angle_noise: float = 0.1
    last_action_noise: float = 0.01
    kick_vel: float = 0.2
    kick_probability: float = 0.02
    terminal_body_z: float = 0.1
    early_termination_step_threshold: int = 500
    terminal_body_angle: float = 0.52
    foot_radius: float = 0.02
    environment_timestep: float = 0.02
    physics_timestep: float = 0.004
    use_imu: bool = True
    privileged_obs: bool = False
    gait_phase_observation: bool = False
    gait_frequency: float = 2.5  # Hz
    disturbance_curriculum: bool = False
    start_position: StartPositionConfig = field(default_factory=StartPositionConfig)
    n_obstacles: int = 0
    obstacle_seed: int = 0
    obstacle_x_range: Tuple[float, float] = (-5.0, 5.0)
    obstacle_y_range: Tuple[float, float] = (-5.0, 5.0)
    obstacle_height: float = 0.02
    obstacle_length: float = 3.0
    heightfield: bool = False
    heightfield_seed: int = 0
    heightfield_nrow: int = 32
    heightfield_ncol: int = 32
    heightfield_size: Tuple[float, float, float, float] = (4.0, 4.0, 0.04, 0.01)


@dataclass(frozen=True)
class DomainRandomizationConfig:
    """domain_randomize ranges."""

    enabled: bool = True
    friction_range: Tuple[float, float] = (0.6, 1.4)
    kp_multiplier_range: Tuple[float, float] = (0.75, 1.25)
    kd_multiplier_range: Tuple[float, float] = (0.5, 2.0)
    body_com_x_shift_range: Tuple[float, float] = (-0.03, 0.03)
    body_com_y_shift_range: Tuple[float, float] = (-0.01, 0.01)
    body_com_z_shift_range: Tuple[float, float] = (-0.02, 0.02)
    body_inertia_scale_range: Tuple[float, float] = (0.7, 1.3)
    body_mass_scale_range: Tuple[float, float] = (0.7, 1.3)


@dataclass(frozen=True)
class TrainConfig:
    """PPO hyperparameters (the ``ppo.train`` invocation surface)."""

    num_timesteps: int = 500_000_000
    episode_length: int = 1000
    num_envs: int = 4096
    num_eval_envs: int = 128
    learning_rate: float = 3e-4
    lr_schedule: str = "constant"
    lr_final_fraction: float = 0.0
    entropy_cost: float = 1e-2
    entropy_schedule: str = "constant"
    entropy_cost_final: float = 0.0
    discounting: float = 0.97
    unroll_length: int = 20
    batch_size: int = 256
    num_minibatches: int = 32
    num_updates_per_batch: int = 4
    reward_scaling: float = 1.0
    clipping_epsilon: float = 0.3
    gae_lambda: float = 0.95
    normalize_observations: bool = True
    privileged_critic: bool = False
    curriculum_steps: int = 0
    seed: int = 0
    num_evals: int = 10
    activation: str = "elu"
    policy_hidden_layer_sizes: Tuple[int, ...] = (128, 128, 128, 128)
    value_hidden_layer_sizes: Tuple[int, ...] = (256, 256, 256, 256, 256)
    value_precision: str = "highest"
    lazy_shuffle: bool = False
    checkpoint_path: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    progress_plot: Optional[str] = None


@dataclass(frozen=True)
class ExperimentConfig:
    env: EnvConfig = field(default_factory=EnvConfig)
    domain_randomization: DomainRandomizationConfig = field(
        default_factory=DomainRandomizationConfig
    )
    train: TrainConfig = field(default_factory=TrainConfig)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def config_hash(cfg) -> str:
    """Stable short hash of the full config; the same config hashes to the
    same string as in the JAX package."""
    blob = json.dumps(to_dict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _build(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if f.type in _NESTED:  # postponed annotations: resolve by name
            kwargs[f.name] = _build(_NESTED[f.type], value)
        elif isinstance(value, list):
            kwargs[f.name] = tuple(value)
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


_NESTED = {
    "EnvConfig": EnvConfig,
    "DomainRandomizationConfig": DomainRandomizationConfig,
    "TrainConfig": TrainConfig,
    "StartPositionConfig": StartPositionConfig,
}


def from_dict(data: dict) -> ExperimentConfig:
    return _build(ExperimentConfig, data)


def parse_override(kv: str):
    """``KEY=VALUE`` of a CLI's ``--set`` as (key, value): the value as JSON
    where it parses, else the string."""
    key, _, raw = kv.partition("=")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return key, value


def apply_overrides(cfg: ExperimentConfig, overrides: dict) -> ExperimentConfig:
    """Apply dotted-path overrides, e.g. ``{"train.num_envs": 8192}``; an
    unknown key raises ``KeyError: unknown config key``."""
    data = to_dict(cfg)
    for path, value in overrides.items():
        node = data
        parts = path.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                raise KeyError(f"unknown config key: {path}")
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {path}")
        node[parts[-1]] = value
    return from_dict(data)
