"""The env steps: their emissions, plain versions and kernels.

Counterpart of ``puppax/env/soa_env.py``. ``_emit_env_step`` re-emits the
env step core (kick -> action latency -> motor targets -> physics
substeps -> observation -> 18 rewards -> termination -> command resample)
in the value algebra of ``physics/soa.py``. Two programs are built on it,
each with a plain version and two kernels:

* the wrapped step (K3, the rollout fast lane): ``_emit_wrapped_step``
  adds the Episode/AutoReset wrapper algebra. ``wrapped_step_rows`` is the
  plain version, every value a ``(B,)`` torch tensor (counterpart of
  ``wrapped_step_rows_xla``); ``wrapped_step`` launches the same program
  split across the warps of a block (``kernels/team.py``) inside
  ``csrc/wrapped_step_team.cuh`` (team K3); ``wrapped_step_one_thread``
  the generated C (``kernels/cgen.py``) inside ``csrc/wrapped_step.cuh``,
  one env per thread (the A/B baseline);
* the unwrapped step (K2, ``PupperV3Env.step``, the evaluator's lane):
  ``emit_env_rows`` adds the last forward pass's caches
  (``soa._emit_caches``). ``env_step_rows`` is the plain version and
  ``env_step`` launches the program split across the warps of a block
  (``kernels/team.py``) inside ``csrc/env_step_team.cuh`` (team K2);
  ``env_step_one_thread`` the generated C inside ``csrc/env_step.cuh``,
  one env per thread (the A/B baseline).

Every array is ``(rows, B)`` row-major float32, with no padding (the JAX
package's ``TILE_B`` tiles have no counterpart). Random draws enter as
input rows (``noise``), so every back-end and the JAX package can be fed
the same numbers. ``env_block`` lays a State's info out in the env rows
every kernel reads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from puppax_torch.kernels import build
from puppax_torch.physics import soa
from puppax_torch.physics.soa import (
    add, clip, fma, materialize, maximum, mul, qrot, sub, vadd3, vcross3,
    vdot3, vsub3, where,
)

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


def _mat(x, ref):
    return materialize(x, ref)


def _lt(a, b, ref):
    """a < b as a 0/1 float mask."""
    return where(_mat(a, ref) < _mat(b, ref), 1.0, 0.0)


def _or(a, b):
    return maximum(a, b)


def _clip(x, lo, hi, ref):
    return clip(_mat(x, ref), lo, hi)


def _qconj(q):
    return [q[0], mul(-1.0, q[1]), mul(-1.0, q[2]), mul(-1.0, q[3])]


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

        # rows of the unwrapped step's env-out block (the K2 kernel)
        self.out_rows: Dict[str, Tuple[int, int]] = {}
        r = 0
        for name, n in (
            ("obs_history", self.hist),
            ("reward", 1),
            ("done", 1),
            ("action_buffer", 12 * self.Da),
            ("imu_buffer", 6 * self.Di),
            ("command", 3),
            ("desired_z", 3),
            ("feet_air_time", 4),
            ("last_contact", 4),
            ("step", 1),
            ("rewards", len(REWARD_ORDER)),
            ("total_dist", 1),
        ):
            self.out_rows[name] = (r, n)
            r += n
        self.nout_rows = r


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


# ---------------------------------------------------------------------------
# env-step emission (value algebra; mirrors PupperV3Env._step_core)
# ---------------------------------------------------------------------------


@soa.with_cse
def _emit_env_step(
    s: soa._Static,
    es: _EnvStatic,
    q: List,
    v: List,
    act: List,
    env: Dict[str, List],
    noi: Dict[str, List],
    dr: Dict[str, List],
    n_substeps: int,
):
    """Emit the full step core. Returns (q2, v2, fw, out) with ``out`` a
    dict of lists of algebra values (obs_history, reward, done, the carried
    env fields, the 18 scaled reward terms, total_dist)."""
    ref = q[0]

    # kick
    v = list(v)
    v[0] = add(v[0], noi["kick"][0])
    v[1] = add(v[1], noi["kick"][1])

    # action latency: push-front + one-hot select
    Da = es.Da
    new_abuf, lag = [], []
    for j in range(12):
        cols = [act[j]] + [env["action_buffer"][j * Da + d] for d in range(Da - 1)]
        new_abuf.extend(cols)
        acc = 0.0
        for d in range(Da):
            acc = fma(acc, noi["act_lat"][d], cols[d])
        lag.append(acc)

    # motor targets
    ctrl = [
        _clip(
            add(es.default_pose[j], mul(lag[j], es.action_scale)),
            es.lowers[j], es.uppers[j], ref,
        )
        for j in range(12)
    ]

    # physics
    qp, vp, fw = soa._emit_substeps(s, q, v, ctrl, dr, n_substeps)
    q2, v2 = soa._emit_integrate(s, qp, vp, fw["qacc"])

    torso_q = fw["xquat"][es.torso_body]
    qc = _qconj(torso_q)
    ang_l, vel_l = soa._link_velocities(s, fw)
    torso_ang = ang_l[es.torso_body - 1]
    torso_vel = vel_l[es.torso_body - 1]

    # ---- observation ----
    if es.use_imu:
        local_ang = qrot(torso_ang, qc)
        grav_body = qrot([0.0, 0.0, -1.0], qc)
    else:
        local_ang = [0.0, 0.0, 0.0]
        grav_body = [0.0, 0.0, -1.0]
    ng = vadd3(grav_body, noi["gravity_noise"])
    gnorm = soa.sqrt(_mat(vdot3(ng, ng), ref))
    ng = [_mat(c, ref) / gnorm for c in ng]
    na = vadd3(local_ang, noi["ang_vel_noise"])
    imu_data = list(na) + list(ng)

    Di = es.Di
    new_ibuf, lagged_imu = [], []
    for j in range(6):
        cols = [imu_data[j]] + [env["imu_buffer"][j * Di + d] for d in range(Di - 1)]
        new_ibuf.extend(cols)
        acc = 0.0
        for d in range(Di):
            acc = fma(acc, noi["imu_lat"][d], cols[d])
        lagged_imu.append(acc)

    obs36 = (
        lagged_imu
        + list(env["command"])
        + list(env["desired_z"])
        + [
            add(sub(q2[7 + j], es.default_pose[j]), noi["motor_ang_noise"][j])
            for j in range(12)
        ]
        + [add(env["last_act"][j], noi["last_action_noise"][j]) for j in range(12)]
    )
    obs36 = [_clip(o, -100.0, 100.0, ref) for o in obs36]
    obs_hist = obs36 + list(env["obs_history"][: es.hist - es.obs_dim])

    # ---- foot contact ----
    foot_z = [fw["sites"][sid][2] for sid in es.feet_sites]
    contact, filt_mm, filt_cm, first_contact, fat1 = [], [], [], [], []
    for i in range(4):
        fz = sub(foot_z[i], es.foot_radius)
        c = _lt(fz, 1e-3, ref)
        lc = env["last_contact"][i]
        contact.append(c)
        filt_mm.append(_or(c, _mat(lc, ref)))
        filt_cm.append(_or(_lt(fz, 3e-2, ref), _mat(lc, ref)))
        first_contact.append(mul(_lt(0.0, env["feet_air_time"][i], ref), filt_mm[i]))
        fat1.append(add(env["feet_air_time"][i], es.dt))

    # ---- termination ----
    rot_up = qrot([0.0, 0.0, 1.0], torso_q)
    done = _lt(rot_up[2], es.cos_term, ref)
    for j in range(12):
        done = _or(done, _lt(q2[7 + j], es.lowers[j], ref))
        done = _or(done, _lt(es.uppers[j], q2[7 + j], ref))
    done = _or(done, _lt(fw["xpos"][es.torso_body][2], es.terminal_z, ref))

    # ---- rewards ----
    sigma = es.sigma
    cmd = env["command"]
    local_vel = qrot(torso_vel, qc)
    local_angv = qrot(torso_ang, qc)

    e_lin = add(
        mul(sub(cmd[0], local_vel[0]), sub(cmd[0], local_vel[0])),
        mul(sub(cmd[1], local_vel[1]), sub(cmd[1], local_vel[1])),
    )
    r_tracking_lin = soa.exp(_mat(mul(e_lin, -1.0 / sigma), ref))
    e_ang = mul(sub(cmd[2], local_angv[2]), sub(cmd[2], local_angv[2]))
    r_tracking_ang = soa.exp(_mat(mul(e_ang, -1.0 / sigma), ref))

    wz_body = qrot([0.0, 0.0, 1.0], qc)
    e_ori = 0.0
    for i in range(3):
        d = sub(wz_body[i], env["desired_z"][i])
        e_ori = add(e_ori, mul(d, d))
    r_tracking_ori = soa.exp(_mat(mul(e_ori, -1.0 / sigma), ref))

    r_lin_vel_z = mul(torso_vel[2], torso_vel[2])
    r_ang_vel_xy = add(mul(torso_ang[0], torso_ang[0]), mul(torso_ang[1], torso_ang[1]))
    r_orientation = add(mul(rot_up[0], rot_up[0]), mul(rot_up[1], rot_up[1]))

    r_torques = 0.0
    for i in range(s.nv):
        r_torques = add(r_torques, mul(fw["qfrc_actuator"][i], fw["qfrc_actuator"][i]))

    r_joint_acc = 0.0
    inv_dt = 1.0 / es.dt
    for j in range(12):
        d = mul(sub(v2[6 + j], env["last_vel"][j]), inv_dt)
        r_joint_acc = add(r_joint_acc, mul(d, d))

    r_mech = 0.0
    for j in range(12):
        r_mech = add(
            r_mech, soa.abs_(_mat(mul(fw["qfrc_actuator"][6 + j], v2[6 + j]), ref))
        )

    r_action_rate = 0.0
    for j in range(12):
        d = sub(act[j], env["last_act"][j])
        r_action_rate = add(r_action_rate, mul(d, d))

    cmd_norm = soa.sqrt(_mat(vdot3(cmd, cmd), ref))

    ss_pose = 0.0
    for j in range(12):
        ss_pose = add(ss_pose, soa.abs_(_mat(sub(q2[7 + j], es.default_pose[j]), ref)))
    r_stand_still = mul(ss_pose, _lt(cmd_norm, 0.1, ref))

    ss_vel = 0.0
    for j in range(12):
        ss_vel = add(ss_vel, soa.abs_(_mat(v2[6 + j], ref)))
    r_ss_joint_vel = mul(ss_vel, _lt(cmd_norm, es.ss_thresh, ref))

    r_abduction = 0.0
    for k in range(4):
        d = sub(q2[7 + 1 + 3 * k], es.desired_abduction[k])
        r_abduction = add(r_abduction, mul(d, d))

    r_air = 0.0
    for i in range(4):
        r_air = add(r_air, mul(sub(fat1[i], 0.1), first_contact[i]))
    r_air = mul(r_air, _lt(0.05, cmd_norm, ref))

    r_slip = 0.0
    for i in range(4):
        b = es.lower_leg_bodies[i]
        off = vsub3(fw["sites"][es.feet_sites[i]], fw["xpos"][b])
        fv = vadd3(vel_l[b - 1], vcross3(ang_l[b - 1], off))
        sq = add(mul(fv[0], fv[0]), mul(fv[1], fv[1]))
        r_slip = add(r_slip, mul(sq, filt_cm[i]))

    r_term = mul(done, _lt(env["step"][0], float(es.early_term), ref))

    def _pair_count(pair_ids):
        # the box pairs among them (obstacle terrain) as one loop over the boxes
        box = fw.get("boxes")
        in_box = [] if box is None else [p for p in pair_ids if box.holds(p)]
        acc = 0.0
        for p in pair_ids:
            if p in in_box:
                if p == in_box[0]:
                    acc = box.fold_dist(acc, in_box, lambda a, d: add(a, _lt(d, 0.0, ref)),
                                        ref)
                continue
            acc = add(acc, _lt(fw["con_dist"][p], 0.0, ref))
        return acc

    r_knee = _pair_count(es.knee_pairs)
    r_body = _pair_count(es.body_pairs)

    terms = {
        "tracking_lin_vel": r_tracking_lin,
        "tracking_ang_vel": r_tracking_ang,
        "tracking_orientation": r_tracking_ori,
        "lin_vel_z": r_lin_vel_z,
        "ang_vel_xy": r_ang_vel_xy,
        "orientation": r_orientation,
        "torques": r_torques,
        "joint_acceleration": r_joint_acc,
        "mechanical_work": r_mech,
        "action_rate": r_action_rate,
        "stand_still": r_stand_still,
        "stand_still_joint_velocity": r_ss_joint_vel,
        "abduction_angle": r_abduction,
        "feet_air_time": r_air,
        "foot_slip": r_slip,
        "termination": r_term,
        "knee_collision": r_knee,
        "body_collision": r_body,
    }
    scaled = {k: mul(terms[k], es.scales[k]) for k in REWARD_ORDER}
    total = 0.0
    for k in REWARD_ORDER:
        total = add(total, scaled[k])
    reward = _clip(mul(total, es.dt), 0.0, 10000.0, ref)

    # ---- carried-field updates ----
    fat2 = [mul(fat1[i], sub(1.0, filt_mm[i])) for i in range(4)]
    stepc = add(env["step"][0], 1.0)
    resample = _lt(float(es.resample_step), stepc, ref)
    cmd2 = [
        where(resample > 0.5, _mat(noi["resample_cmd"][i], ref), _mat(cmd[i], ref))
        for i in range(3)
    ]
    dz2 = [
        where(
            resample > 0.5,
            _mat(noi["resample_ori"][i], ref),
            _mat(env["desired_z"][i], ref),
        )
        for i in range(3)
    ]
    stepc = where(_or(done, resample) > 0.5, 0.0, _mat(stepc, ref))

    tx = fw["xpos"][es.torso_body]
    total_dist = soa.sqrt(_mat(vdot3(tx, tx), ref))

    out = {
        "obs_history": obs_hist,
        "reward": [reward],
        "done": [done],
        "action_buffer": new_abuf,
        "imu_buffer": new_ibuf,
        "command": cmd2,
        "desired_z": dz2,
        "feet_air_time": fat2,
        "last_contact": contact,
        "step": [stepc],
        "rewards": [scaled[k] for k in REWARD_ORDER],
        "total_dist": [total_dist],
    }
    if es.priv:
        # the privileged rows (``pupper.py:292-331``), of the same post-step
        # quantities: the torso's true local linear and angular velocity and
        # gravity, the joint velocities, this step's contact, the updated
        # feet air time, this step's kick and the DR leaves (friction as
        # pair_mu[0], kp as gain0[0], the torso's mass)
        out["privileged"] = (
            list(local_vel) + list(local_angv) + list(qrot([0.0, 0.0, -1.0], qc))
            + [v2[6 + j] for j in range(12)] + list(contact) + list(fat2) + list(noi["kick"])
            + [dr["pair_mu"][0], dr["gain0"][0], dr["mass"][es.torso_body]]
        )
        assert len(out["privileged"]) == es.npriv
    return q2, v2, fw, out


# ---------------------------------------------------------------------------
# wrapped step: env step + episode bookkeeping + auto-reset
# ---------------------------------------------------------------------------

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


def _sel(mask, a, b, ref):
    """where(mask > 0.5, a, b) over algebra values."""
    return where(_mat(mask, ref) > 0.5, _mat(a, ref), _mat(b, ref))


@soa.with_cse
def _emit_wrapped_step(
    s: soa._Static,
    es: _EnvStatic,
    q: List,
    v: List,
    act: List,
    env: Dict[str, List],
    noi: Dict[str, List],
    dr: Dict[str, List],
    first_q: List,
    first_v: List,
    first_obs: List,
    first_priv: List,
    steps,
    prev_done,
    n_substeps: int,
    episode_length: int,
):
    """One WRAPPED env step (brax order):

      steps_in = where(prev_done, 0, steps)          # AutoReset prologue
      ...env step core...
      steps2  = steps_in + 1                          # EpisodeWrapper
      done2   = env_done OR steps2 >= episode_length
      trunc   = (steps2 >= L) * (1 - env_done)
      q/v/obs = where(done2, first_*, new)            # AutoReset restore
      priv    = where(done2, first_priv, new)         # (with privileged rows)

    Returns (q_out, v_out, env_out rows in INPUT order, steps2, done2, aux).
    """
    ref = q[0]

    steps_in = _sel(prev_done, 0.0, steps, ref)

    q2, v2, fw, out = _emit_env_step(s, es, q, v, act, env, noi, dr, n_substeps)
    env_done = out["done"][0]

    steps2 = add(steps_in, 1.0)
    # steps2 >= L (steps are exact small integers in f32)
    trunc_flag = _lt(float(episode_length) - 0.5, steps2, ref)
    done2 = _or(_mat(env_done, ref), trunc_flag)
    truncation = mul(trunc_flag, sub(1.0, env_done))

    q_out = [_sel(done2, first_q[i], q2[i], ref) for i in range(s.nq)]
    v_out = [_sel(done2, first_v[i], v2[i], ref) for i in range(s.nv)]
    obs_out = [
        _sel(done2, first_obs[i], out["obs_history"][i], ref)
        for i in range(es.hist)
    ]

    # last_act is the raw action, last_vel the PRE-restore joint velocity
    env_out: Dict[str, List] = {
        "action_buffer": out["action_buffer"],
        "imu_buffer": out["imu_buffer"],
        "command": out["command"],
        "desired_z": out["desired_z"],
        "last_act": list(act),
        "last_vel": [v2[6 + j] for j in range(12)],
        "feet_air_time": out["feet_air_time"],
        "last_contact": out["last_contact"],
        "step": out["step"],
        "obs_history": obs_out,
    }
    aux = {
        "reward": out["reward"],
        "done": [done2],
        "truncation": [truncation],
        "rewards": out["rewards"],
        "total_dist": out["total_dist"],
    }
    if es.priv:
        # AutoReset restores the privileged obs on the effective done too
        # (``wrappers.py:159-165``)
        aux["privileged"] = [_sel(done2, first_priv[i], out["privileged"][i], ref)
                             for i in range(es.npriv)]
    return q_out, v_out, env_out, steps2, done2, aux


def block_rows(s: soa._Static, es: _EnvStatic) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Row counts of the 8 input blocks (q, v, act, env, noise, dr, first,
    wrap) and the 5 output blocks (q, v, env, wrap, aux)."""
    naux = sum(n for _, n in aux_row_map(es).values())
    nfirst = s.nq + s.nv + es.hist + es.npriv
    return (
        (s.nq, s.nv, s.nu, es.nenv_rows, es.nnoise_rows, s.ndr, nfirst, 2),
        (s.nq, s.nv, es.nenv_rows, 2, naux),
    )


def _split(row_map, values) -> Dict[str, List]:
    return {name: [values[r0 + i] for i in range(n)] for name, (r0, n) in row_map.items()}


def emit_wrapped_rows(s, es, n_substeps, episode_length, rows):
    """Run ``_emit_wrapped_step`` on 8 lists of per-row values (either
    back-end). Returns the 5 output lists in block order."""
    q, v, act, env_r, noi_r, dr_r, first_r, wrap_r = rows
    env, noi, dr = _split(es.env_rows, env_r), _split(es.noise_rows, noi_r), _split(s.dr_rows, dr_r)
    first_q = first_r[: s.nq]
    first_v = first_r[s.nq : s.nq + s.nv]
    first_obs = first_r[s.nq + s.nv : s.nq + s.nv + es.hist]
    first_priv = first_r[s.nq + s.nv + es.hist : s.nq + s.nv + es.hist + es.npriv]
    q_out, v_out, env_out, steps2, done2, aux = _emit_wrapped_step(
        s, es, q, v, act, env, noi, dr, first_q, first_v, first_obs, first_priv,
        wrap_r[0], wrap_r[1], n_substeps, episode_length,
    )
    env_flat = [x for name in es.env_rows for x in env_out[name]]
    aux_flat = [x for name in aux_row_map(es) for x in aux[name]]
    return q_out, v_out, env_flat, [steps2, done2], aux_flat


def wrapped_step_rows(s, es, n_substeps, episode_length, *blocks):
    """The plain version: the wrapped-step emission evaluated with torch
    ops on ``(rows, B)`` blocks (q, v, act, env, noise, dr, first, wrap).
    Returns (q', v', env', wrap', aux) as ``(rows, B)`` float32."""
    return soa.plain_rows(lambda rows: emit_wrapped_rows(s, es, n_substeps, episode_length, rows),
                  blocks)


def _wrapped_step(wrapper, kernel: build.Kernel, library, s, es, n_substeps, episode_length,
                  blocks):
    """The K3 wrappers' body: the plain version on CPU tensors, else one
    launch of ``kernel`` from ``library(s, es, n_substeps, episode_length)``,
    counted on ``wrapper``."""
    in_rows, out_rows = block_rows(s, es)
    B, dev = build.check_blocks(in_rows, blocks)
    if dev.type == "cpu":
        return wrapped_step_rows(s, es, n_substeps, episode_length, *blocks)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {dev}")
    lib = library(s, es, n_substeps, episode_length)
    build.bind_scratch(lib, kernel, B, dev)
    outs = build.launch(kernel.name, getattr(lib, kernel.launch), blocks, out_rows, B, dev)
    wrapper.launches += 1
    return outs


def wrapped_step(s, es, n_substeps, episode_length, *blocks):
    """One wrapped env step over ``(rows, B)`` blocks.

    CPU tensors run the plain version (``wrapped_step_rows``); CUDA tensors
    launch team K3 (``csrc/wrapped_step_team.cuh``: 32 envs per block, each
    env's program split across the block's warps) on the current stream, or
    raise. Each launch adds one to ``wrapped_step.launches``."""
    return _wrapped_step(wrapped_step, build.WRAPPED_STEP_TEAM, build.wrapped_step_team_library,
                         s, es, n_substeps, episode_length, blocks)


wrapped_step.launches = 0


def wrapped_step_one_thread(s, es, n_substeps, episode_length, *blocks):
    """``wrapped_step`` through the one-thread K3 (``csrc/wrapped_step.cuh``,
    one env per thread): the A/B baseline of ``chip_smoke.py``. Each launch
    adds one to ``wrapped_step_one_thread.launches``."""
    return _wrapped_step(wrapped_step_one_thread, build.WRAPPED_STEP, build.wrapped_step_library,
                         s, es, n_substeps, episode_length, blocks)


wrapped_step_one_thread.launches = 0


# ---------------------------------------------------------------------------
# unwrapped step: the env step core plus the last forward pass's caches (K2)
# ---------------------------------------------------------------------------


def env_block_rows(s: soa._Static, es: _EnvStatic):
    """Row counts of the unwrapped step's 6 input blocks (q, v, act, env,
    noise, dr) and 4 output blocks (q, v, caches, env_out)."""
    return (
        (s.nq, s.nv, s.nu, es.nenv_rows, es.nnoise_rows, s.ndr),
        (s.nq, s.nv, s.ncache, es.nout_rows),
    )


@soa.with_cse
def emit_env_rows(s, es, n_substeps, rows):
    """Run ``_emit_env_step`` and ``soa._emit_caches`` on 6 lists of
    per-row values (either back-end). Returns the 4 output lists in block
    order: q', v', the caches (``s.cache_rows``) and the env-out rows
    (``es.out_rows``)."""
    q, v, act, env_r, noi_r, dr_r = rows
    q2, v2, fw, out = _emit_env_step(
        s, es, q, v, act, _split(es.env_rows, env_r), _split(es.noise_rows, noi_r),
        _split(s.dr_rows, dr_r), n_substeps,
    )
    caches = soa._emit_caches(s, fw)
    env_out = []
    for name, (_, n) in es.out_rows.items():
        assert len(out[name]) == n, (name, len(out[name]), n)
        env_out.extend(out[name])
    return q2, v2, caches, env_out


def env_step_rows(s, es, n_substeps, *blocks):
    """The plain version of K2: the env-step emission evaluated with torch
    ops on ``(rows, B)`` blocks (q, v, act, env, noise, dr). Returns (q',
    v', caches, env_out) as ``(rows, B)`` float32."""
    return soa.plain_rows(lambda rows: emit_env_rows(s, es, n_substeps, rows), blocks)


def _env_step(wrapper, kernel: build.Kernel, library, s, es, n_substeps, blocks):
    """The wrappers' body: the plain version on CPU tensors, else one launch
    of ``kernel`` from ``library(s, es, n_substeps)``, counted on ``wrapper``."""
    in_rows, out_rows = env_block_rows(s, es)
    B, dev = build.check_blocks(in_rows, blocks)
    if dev.type == "cpu":
        return env_step_rows(s, es, n_substeps, *blocks)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {dev}")
    lib = library(s, es, n_substeps)
    build.bind_scratch(lib, kernel, B, dev)
    outs = build.launch(kernel.name, getattr(lib, kernel.launch), blocks, out_rows, B, dev)
    wrapper.launches += 1
    return outs


def env_step(s, es, n_substeps, *blocks):
    """One unwrapped env step over ``(rows, B)`` blocks.

    CPU tensors run the plain version (``env_step_rows``); CUDA tensors
    launch team K2 (``csrc/env_step_team.cuh``: 32 envs per block, each
    env's program split across the block's warps) on the current stream, or
    raise. Each launch adds one to ``env_step.launches``."""
    return _env_step(env_step, build.ENV_STEP_TEAM, build.env_step_team_library, s, es,
                     n_substeps, blocks)


env_step.launches = 0


def env_step_one_thread(s, es, n_substeps, *blocks):
    """``env_step`` through the one-thread K2 (``csrc/env_step.cuh``, one env
    per thread): the A/B baseline of ``chip_smoke.py``. Each launch adds one
    to ``env_step_one_thread.launches``."""
    return _env_step(env_step_one_thread, build.ENV_STEP, build.env_step_library, s, es,
                     n_substeps, blocks)


env_step_one_thread.launches = 0
