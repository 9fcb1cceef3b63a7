"""Shared set-up of the puppax_torch parity tests.

Every test of the port builds the same small configuration in both
packages: one physics substep per env step (the ``tests/test_soa_env.py``
trick that keeps the JAX emission's eager evaluation short), pitch/roll
commands on so the desired-orientation rows are not constant, and a batch
of ``B`` envs. Inputs are drawn with numpy from a seed and handed to both
packages. The module imports no JAX at import time, so the GPU tests
(``tests/test_torch_cuda.py``) can use it on a host without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from puppax_torch import random

B = 8
EPISODE_LENGTH = 50
PHYSICS_DT = 0.004


def env_keys(n: int = B, seed: int = 0, device="cpu") -> torch.Tensor:
    """``n`` per-env keys, ``jax.random.split(PRNGKey(seed), n)``, as the
    port's ``(n, 2)`` int32 keys."""
    return random.split(random.key(seed, device), n)


def env_kwargs(n_substeps: int = 1) -> dict:
    """Constructor arguments shared by the JAX env and the port's env."""
    return dict(
        action_scale=0.75,
        observation_history=2,
        maximum_pitch_command=10.0,
        maximum_roll_command=10.0,
        environment_timestep=PHYSICS_DT * n_substeps,
        physics_timestep=PHYSICS_DT,
    )


# run12's env options (dev/run_configs/run12_2b_cse.json): history 4, the
# privileged obs, the gait clock and the disturbance curriculum
RUN12_ENV = dict(observation_history=4, privileged_obs=True, gait_phase_observation=True,
                 disturbance_curriculum=True)


def run12_kwargs(n_substeps: int = 1) -> dict:
    """``env_kwargs`` with run12's env options."""
    return dict(env_kwargs(n_substeps), **RUN12_ENV)


def jax_env(n_substeps: int = 1):
    from puppax.configs import get_config
    from puppax.env import PupperV3Env

    return PupperV3Env(path=None, reward_config=get_config(), **env_kwargs(n_substeps))


def torch_env(n_substeps: int = 1, device="cpu"):
    from puppax_torch.env.pupper import PupperV3Env

    return PupperV3Env(device=device, **env_kwargs(n_substeps))


def jax_dr_model(env, seed: int = 5, num_envs: int = B):
    """``puppax``'s domain-randomized model batched over ``num_envs``."""
    import jax

    from puppax.env.domain_randomization import domain_randomize

    keys = jax.random.split(jax.random.PRNGKey(seed), num_envs)
    model, _ = domain_randomize(env.model, keys)
    return model


def dr_leaves(jax_model) -> dict:
    """The six DR leaves of a batched JAX model as numpy."""
    from puppax_torch.model.mjcf import DR_LEAVES

    return {k: np.array(getattr(jax_model, k)) for k in DR_LEAVES}


def model_from_jax(jax_model):
    """A ``puppax`` RobotModel (float64 or float32, DR-batched leaves
    included) as the port's RobotModel: the static fields as they are, the
    numeric leaves as numpy arrays of their own dtype. The JAX pytree stays
    in the tests; the port reads plain arrays."""
    import dataclasses

    from puppax_torch.model.mjcf import LEAF_FIELDS, STATIC_FIELDS, RobotModel

    kw = {k: getattr(jax_model, k) for k in STATIC_FIELDS}
    kw.update({k: np.array(getattr(jax_model, k)) for k in LEAF_FIELDS})
    for k in ("hfield_data", "hfield_size"):  # the heightfield's, if the model has one
        if getattr(jax_model, k) is not None:
            kw[k] = np.array(getattr(jax_model, k))
    names = {f.name for f in dataclasses.fields(RobotModel)}
    assert names == set(kw) | {"hfield_data", "hfield_size"}, names ^ set(kw)
    return RobotModel(**kw)


def random_states(model, rng: np.random.RandomState, n: int = B):
    """Plausible (qpos, qvel, ctrl) rows: the even envs low enough for
    their feet to touch the floor, the odd ones airborne."""
    key_q = np.tile(np.asarray(model.key_qpos, np.float64), (n, 1))
    qpos = key_q.copy()
    qpos[:, 2] = np.where(np.arange(n) % 2 == 0, rng.uniform(0.10, 0.16, n),
                          rng.uniform(0.17, 0.35, n))
    qpos[:, 0:2] += rng.uniform(-0.5, 0.5, (n, 2))
    quat = rng.normal(0, 1, (n, 4)) * 0.1 + np.array([1.0, 0, 0, 0])
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, 12))
    qvel = rng.uniform(-1.0, 1.0, (n, 18))
    ctrl = key_q[:, 7:] + rng.uniform(-0.3, 0.3, (n, 12))
    f32 = np.float32
    return qpos.astype(f32), qvel.astype(f32), ctrl.astype(f32)


def physics_step_blocks(model, dr_rows: np.ndarray, rng, n: int = B):
    """The 4 ``(rows, n)`` float32 input blocks of one physics-only step
    (q, v, ctrl, dr) on ``random_states``."""
    qpos, qvel, ctrl = random_states(model, rng, n)
    return [qpos.T.copy(), qvel.T.copy(), ctrl.T.copy(), np.ascontiguousarray(dr_rows, np.float32)]


def penetrating_pairs(s, con_dist: np.ndarray) -> np.ndarray:
    """(n, 2) counts of the penetrating plane-sphere and sphere-sphere pairs
    of each env, from a ``(npair, n)`` block of contact distances."""
    kinds = np.array([p.kind for p in s.pairs])
    pen = np.asarray(con_dist) < 0
    return np.stack([pen[kinds == "ps"].sum(0), pen[kinds == "ss"].sum(0)], 1)


def within_caps(m, counts: np.ndarray) -> np.ndarray:
    """Per env: whether the MJX caps keep every penetrating pair, i.e. at
    most ``max_geom_pairs`` of each kind and ``max_contact_points`` in all
    (there the capped XLA path and the uncapped emission agree)."""
    return (counts.max(1) <= m.max_geom_pairs) & (counts.sum(1) <= m.max_contact_points)


def assert_physics_outputs_close(got, want, s, what: str):
    """K1's 3 output blocks (q, v, caches), ``(rows, n)`` numpy: qpos 5e-5,
    qvel 5e-4 scaled by max(1, the env's largest |qvel|), the caches at
    ``CACHE_ATOL`` / ``CACHE_SCALED``."""
    g_q, g_v, g_c = [np.asarray(x, np.float64) for x in got]
    w_q, w_v, w_c = [np.asarray(x, np.float64) for x in want]
    np.testing.assert_allclose(g_q, w_q, atol=5e-5, rtol=0, err_msg=f"{what}: qpos")
    scale_v = np.maximum(1.0, np.abs(w_v).max(axis=0, keepdims=True))
    np.testing.assert_allclose(g_v / scale_v, w_v / scale_v, atol=5e-4, rtol=0,
                               err_msg=f"{what}: scaled qvel")
    assert_cache_rows_close(g_c, w_c, s, what)


def wrapped_step_blocks(s, es, model, dr_rows: np.ndarray, rng, n: int = B,
                        episode_length: int = EPISODE_LENGTH):
    """The 8 ``(rows, n)`` float32 input blocks of one wrapped step
    (q, v, act, env, noise, dr, first, wrap), random as in
    ``tests/test_soa_env.py``. Env 1 enters with ``prev_done = 1`` (the
    AutoReset prologue), envs 2 and 3 at ``steps = L - 1`` (truncation)."""
    f32 = np.float32
    qpos, qvel, _ = random_states(model, rng, n)
    act = rng.uniform(-1, 1, (n, 12)).astype(f32)

    env = np.zeros((es.nenv_rows, n), f32)

    def put(block, rows, name, x):
        r0, k = rows[name]
        block[r0 : r0 + k] = np.asarray(x, f32).reshape(n, k).T

    put(env, es.env_rows, "action_buffer", rng.uniform(-1, 1, (n, 12 * es.Da)))
    put(env, es.env_rows, "imu_buffer", rng.uniform(-1, 1, (n, 6 * es.Di)))
    put(env, es.env_rows, "command", rng.uniform(-0.7, 0.7, (n, 3)))
    put(env, es.env_rows, "desired_z", np.tile([0.05, -0.02, 0.99], (n, 1)))
    put(env, es.env_rows, "last_act", rng.uniform(-1, 1, (n, 12)))
    put(env, es.env_rows, "last_vel", rng.uniform(-2, 2, (n, 12)))
    put(env, es.env_rows, "feet_air_time", rng.uniform(0, 0.3, (n, 4)))
    put(env, es.env_rows, "last_contact", rng.rand(n, 4) < 0.5)
    put(env, es.env_rows, "step", rng.randint(0, 600, n))
    put(env, es.env_rows, "obs_history", rng.uniform(-1, 1, (n, es.hist)))

    noise = np.zeros((es.nnoise_rows, n), f32)
    put(noise, es.noise_rows, "kick",
        rng.uniform(-1, 1, (n, 2)) * (rng.rand(n, 1) < 0.3))
    put(noise, es.noise_rows, "act_lat", np.eye(es.Da)[rng.randint(es.Da, size=n)])
    put(noise, es.noise_rows, "imu_lat", np.eye(es.Di)[rng.randint(es.Di, size=n)])
    put(noise, es.noise_rows, "ang_vel_noise", rng.uniform(-0.3, 0.3, (n, 3)))
    put(noise, es.noise_rows, "gravity_noise", rng.uniform(-0.1, 0.1, (n, 3)))
    put(noise, es.noise_rows, "motor_ang_noise", rng.uniform(-0.1, 0.1, (n, 12)))
    put(noise, es.noise_rows, "last_action_noise", rng.uniform(-0.01, 0.01, (n, 12)))
    put(noise, es.noise_rows, "resample_cmd", rng.uniform(-0.7, 0.7, (n, 3)))
    put(noise, es.noise_rows, "resample_ori", np.tile([-0.03, 0.06, 0.98], (n, 1)))

    fq, fv, _ = random_states(model, rng, n)
    first = np.concatenate(
        [fq.T, fv.T, rng.uniform(-1, 1, (es.hist, n))], 0
    ).astype(f32)
    steps = rng.randint(0, episode_length - 2, n).astype(f32)
    steps[2:4] = episode_length - 1
    prev_done = np.zeros(n, f32)
    prev_done[1] = 1.0
    wrap = np.stack([steps, prev_done]).astype(f32)
    npriv = getattr(es, "npriv", 0)
    if npriv:  # the reset-time privileged rows, drawn last
        first = np.concatenate([first, rng.uniform(-1, 1, (npriv, n)).astype(f32)], 0)
    return [qpos.T.copy(), qvel.T.copy(), act.T.copy(), env, noise,
            np.ascontiguousarray(dr_rows, f32), first, wrap]


def jax_dr_rows(s, model, n: int = B) -> np.ndarray:
    """``puppax``'s DR rows of ``model`` as one ``(ndr, n)`` block."""
    from puppax.physics import soa

    dr = soa.dr_inputs(model, s, n)
    parts = [
        np.asarray(dr[name]).reshape(n, k)
        for name, (r0, k) in sorted(s.dr_rows.items(), key=lambda kv: kv[1][0])
    ]
    return np.concatenate(parts, 1).T.astype(np.float32)


def to_torch(blocks):
    return [torch.from_numpy(np.ascontiguousarray(b)) for b in blocks]


def env_step_blocks(s, es, model, dr_rows: np.ndarray, rng, n: int = B):
    """The 6 ``(rows, n)`` input blocks of one unwrapped step (q, v, act,
    env, noise, dr): the first six of ``wrapped_step_blocks``."""
    return wrapped_step_blocks(s, es, model, dr_rows, rng, n)[:6]


# Tolerances of the last forward pass's caches: positions and rotations as
# qpos (5e-5), velocities, accelerations and forces scaled as qvel (5e-4
# times max(1, the env's largest magnitude in the group)).
CACHE_ATOL = {"xpos": 5e-5, "xquat": 5e-5, "site_xpos": 5e-5, "con_dist": 5e-5,
              "con_pos": 5e-5}
CACHE_SCALED = {"qacc": 5e-4, "xd_ang": 5e-4, "xd_vel": 5e-4, "qfrc_actuator": 5e-4}
ENV_OUT_ATOL = {
    "obs_history": 2e-4, "reward": 2e-4, "done": 0.0, "action_buffer": 1e-6,
    "imu_buffer": 1e-4, "command": 1e-6, "desired_z": 1e-6, "feet_air_time": 1e-5,
    "last_contact": 0.0, "step": 0.0, "total_dist": 1e-4,
}


def assert_cache_rows_close(g_cache, w_cache, s, what: str):
    """``(ncache, n)`` cache blocks at ``CACHE_ATOL`` / ``CACHE_SCALED``."""
    for name, (r0, k) in s.cache_rows.items():
        g, w = g_cache[r0 : r0 + k], w_cache[r0 : r0 + k]
        if name in CACHE_SCALED:
            scale = np.maximum(1.0, np.abs(w).max(axis=0, keepdims=True))
            g, w, tol = g / scale, w / scale, CACHE_SCALED[name]
        else:
            tol = CACHE_ATOL[name]
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what}: caches {name}")


def assert_env_outputs_close(got, want, s, es, what: str):
    """Hold the unwrapped step's 4 output blocks (q, v, caches, env_out),
    ``(rows, n)`` numpy, at the tolerances of
    ``tests/test_soa_env.py:131-193`` and ``CACHE_ATOL``/``CACHE_SCALED``."""
    g_q, g_v, g_c, g_e = [np.asarray(x, np.float64) for x in got]
    w_q, w_v, w_c, w_e = [np.asarray(x, np.float64) for x in want]
    np.testing.assert_allclose(g_q, w_q, atol=5e-5, err_msg=f"{what}: qpos")
    scale_v = np.maximum(1.0, np.abs(w_v).max(axis=0, keepdims=True))
    np.testing.assert_allclose(g_v / scale_v, w_v / scale_v, atol=5e-4,
                               err_msg=f"{what}: scaled qvel")
    assert_cache_rows_close(g_c, w_c, s, what)
    for name, (r0, k) in es.out_rows.items():
        g, w = g_e[r0 : r0 + k], w_e[r0 : r0 + k]
        if name == "rewards":
            bad = np.abs(g - w) > 2e-4 * np.maximum(1.0, np.abs(w))
            assert not bad.any(), (
                f"{what}: reward terms {np.argwhere(bad).tolist()}: {g[bad]} vs {w[bad]}"
            )
        else:
            np.testing.assert_allclose(g, w, atol=ENV_OUT_ATOL[name], rtol=0,
                                       err_msg=f"{what}: env out {name}")


def assert_wrapped_outputs_close(got, want, s, es, aux_rows, what: str):
    """Hold the 5 output blocks (q, v, env, wrap, aux), ``(rows, n)``
    numpy, at the tolerances of ``tests/test_soa_env.py:131-191``."""
    g_q, g_v, g_env, g_wrap, g_aux = [np.asarray(x, np.float64) for x in got]
    w_q, w_v, w_env, w_wrap, w_aux = [np.asarray(x, np.float64) for x in want]
    np.testing.assert_allclose(g_q, w_q, atol=5e-5, err_msg=f"{what}: qpos")
    scale_v = np.maximum(1.0, np.abs(w_v).max(axis=0, keepdims=True))
    np.testing.assert_allclose(g_v / scale_v, w_v / scale_v, atol=5e-4,
                               err_msg=f"{what}: scaled qvel")
    tol = {
        "obs_history": 2e-4, "action_buffer": 1e-6, "imu_buffer": 1e-4,
        "command": 1e-6, "desired_z": 1e-6, "last_act": 1e-6,
        "last_vel": 5e-4, "feet_air_time": 1e-5, "last_contact": 0.0,
        "step": 0.0,
    }
    for name, (r0, k) in es.env_rows.items():
        g, w = g_env[r0 : r0 + k], w_env[r0 : r0 + k]
        if name == "last_vel":
            g, w = g / scale_v, w / scale_v
        np.testing.assert_allclose(g, w, atol=tol[name], rtol=0,
                                   err_msg=f"{what}: env rows {name}")
    np.testing.assert_array_equal(g_wrap, w_wrap, err_msg=f"{what}: steps/done")
    for name, (r0, k) in aux_rows.items():
        g, w = g_aux[r0 : r0 + k], w_aux[r0 : r0 + k]
        if name in ("done", "truncation"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: aux {name}")
        elif name == "rewards":
            bad = np.abs(g - w) > 2e-4 * np.maximum(1.0, np.abs(w))
            assert not bad.any(), (
                f"{what}: reward terms {np.argwhere(bad).tolist()}: {g[bad]} vs {w[bad]}"
            )
        elif name == "privileged":
            assert_privileged_close(g.T, w.T, f"{what}: aux privileged")
        else:
            np.testing.assert_allclose(g, w, atol=2e-4, err_msg=f"{what}: aux {name}")


# the privileged obs' columns (puppax/env/pupper.py:292-331) and their
# tolerances: the torso's local velocities and the joint velocities as qvel
# (5e-4 times max(1, the env's largest of them)), gravity as the
# observation (2e-4), the contact flags exact, the air times as the env
# rows (1e-5), the kick and the DR leaves as copies (1e-6 relative)
PRIV_VELOCITY = np.r_[0:6, 9:21]
PRIV_ATOL = ((slice(6, 9), 2e-4, 0.0), (slice(21, 25), 0.0, 0.0), (slice(25, 29), 1e-5, 0.0),
             (slice(29, 34), 0.0, 1e-6))


def assert_privileged_close(got, want, what: str):
    """``(B, 34)`` privileged observations at the tolerances above."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and got.shape[-1] == 34, (got.shape, want.shape)
    scale = np.maximum(1.0, np.abs(want[..., PRIV_VELOCITY]).max(-1, keepdims=True))
    np.testing.assert_allclose(got[..., PRIV_VELOCITY] / scale, want[..., PRIV_VELOCITY] / scale,
                               atol=5e-4, rtol=0, err_msg=f"{what}: velocities")
    for cols, atol, rtol in PRIV_ATOL:
        np.testing.assert_allclose(got[..., cols], want[..., cols], atol=atol, rtol=rtol,
                                   err_msg=f"{what}: columns {cols.start}:{cols.stop}")


def fused_unroll_inputs(env, n: int, T: int, activation: str, episode_length: int,
                        seed: int = 3):
    """The folded policy layers and the 9 input blocks of one fused unroll
    (q, v, env, wrap, phase or None, first, dr, noise, eps) of ``env`` (its
    device; the clock as the env has it): a reset of ``n`` envs with their
    episode counts staggered (so the envs end at different steps), the
    clocks started apart, T steps of draws and a random policy with a
    non-trivial normalizer."""
    from puppax_torch.env import fused_unroll
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.train import networks, running_statistics

    dev = env.device
    wrapped = wrap_for_training(env, episode_length)
    g = torch.Generator(device=dev).manual_seed(seed)
    key_env, key_net = random.split(random.key(seed, dev)).unbind(0)
    state = wrapped.reset(random.split(key_env, n))
    info = dict(state.info, steps=torch.arange(n, dtype=torch.float32, device=dev)
                % episode_length)
    if env._gait_phase_obs:
        info["gait_phase"] = torch.linspace(0.5, 6.27, n, device=dev)
    lane = FastLane(wrapped)
    carry = lane.carry_from_state(state.replace(info=info))
    _, noise, _ = lane.draw_noise_block(state.info["rng"], T)
    eps = torch.randn((T, env.action_size, n), generator=g, device=dev)
    policy = networks.make_ppo_networks(env.observation_size, env.action_size, (32, 32),
                                        (32, 32), activation=activation, device=dev,
                                        key=key_net).policy_network
    obs = env.observation_size
    norm = running_statistics.from_jax(np.linspace(-0.1, 0.1, obs), np.linspace(0.9, 1.1, obs),
                                       device=dev)
    blocks = [carry[k] for k in ("q", "v", "env", "wrap")] + [
        carry.get("phase"), carry["first"], carry["dr"], noise, eps]
    return fused_unroll.fold_normalizer(norm, policy), blocks


def box_model_config(n_boxes: int = 3, seed: int = 0):
    """A small obstacle terrain: ``n_boxes`` boxes within a metre of the
    origin, where random bases find them."""
    from puppax_torch.configs.experiment import EnvConfig

    return EnvConfig(n_obstacles=n_boxes, obstacle_x_range=(-1.0, 1.0),
                     obstacle_y_range=(-1.0, 1.0), obstacle_seed=seed)


def place_over_boxes(model, qpos: np.ndarray, rng: np.random.RandomState, envs,
                     tries: int = 1024) -> np.ndarray:
    """``(n, nq)`` qpos with the bases of ``envs`` moved (x, y within a
    metre of the origin, z 0.10-0.16) to a pose where a sphere penetrates a
    box, the first of ``tries`` random ones that does (the pose is kept
    where none does). Returns the qpos; ``box_contacts`` counts them."""
    from puppax_torch.physics import pipeline

    m = pipeline.model_tensors(model, torch.float32, "cpu")
    out = np.array(qpos, np.float32)
    for e in envs:
        cand = np.repeat(out[e:e + 1], tries, 0)
        cand[:, 0:2] = rng.uniform(-1.0, 1.0, (tries, 2))
        cand[:, 2] = rng.uniform(0.10, 0.16, tries)
        hit = np.flatnonzero(box_contacts(model, cand, m))
        if len(hit):
            out[e] = cand[hit[0]]
    return out


def box_contacts(model, qpos: np.ndarray, m=None) -> np.ndarray:
    """Per env of ``(n, nq)`` qpos: whether a sphere penetrates a box."""
    from puppax_torch.physics import collision, pipeline, smooth

    m = pipeline.model_tensors(model, torch.float32, "cpu") if m is None else m
    dist = collision.collide_pairs(m, smooth.kinematics(m, torch.from_numpy(
        np.asarray(qpos, np.float32)))).dist.numpy()
    nb = len(model.pairs_sphere_box)
    first = len(model.pairs_plane_sphere) + len(model.pairs_sphere_sphere)
    return (dist[:, first:first + nb] < 0).any(1)
