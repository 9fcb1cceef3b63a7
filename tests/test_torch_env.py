"""The port's env reset and random draws against puppax.

``puppax``'s reset draws from per-env threefry keys, and so does the
port's (``puppax_torch.random``); ``tests/test_torch_random.py`` holds the
two seed for seed. Here the reset CORE: the test replays ``puppax``'s key splits
(``pupper.py:384-393,848-875``, ``domain_randomization.py:189-210``) to
recover the values its ``wrapped.reset`` drew, hands them to the port's
``reset_from_draws`` and compares every field the fast lane reads. The
port's own draws are checked for shape, range and the DR contract (one
friction scalar per env on every geom).
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax import utils as jutils
from puppax.env import domain_randomization as jdr
from puppax.env import wrappers as jwrappers
from puppax_torch.configs import DomainRandomizationConfig, EnvConfig
from puppax_torch.env.domain_randomization import domain_randomize
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.wrappers import wrap_for_training

torch.set_num_threads(1)


def _jax_reset_draws(env, rngs):
    """The values ``PupperV3Env.reset`` draws from each env's key."""

    def one(k):
        rng, cmd_key, ori_key, pos_key = jax.random.split(k, 4)
        out = {
            "qpos": jdr.randomize_qpos(env._init_q, env._start_position_config, rng=pos_key),
            "command": env.sample_command(cmd_key),
            "desired_z": env.sample_body_orientation(ori_key),
        }
        _, ang, grav, motor, last, imu = jax.random.split(rng, 6)
        u = lambda key, n: jax.random.uniform(key, (n,), minval=-1, maxval=1)  # noqa: E731
        out["ang_vel_noise"] = u(ang, 3) * env._angular_velocity_noise
        out["gravity_noise"] = u(grav, 3) * env._gravity_noise
        out["motor_ang_noise"] = u(motor, 12) * env._motor_angle_noise
        out["last_action_noise"] = u(last, 12) * env._last_action_noise
        out["imu_lat"] = jutils.latency_onehot(imu, env._imu_latency_distribution)
        return out

    return {k: np.array(v) for k, v in jax.vmap(one)(rngs).items()}


@pytest.fixture(scope="module")
def resets():
    jenv = H.jax_env()
    jwrapped = jwrappers.wrap_for_training(
        jenv, H.EPISODE_LENGTH, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B),
    )
    rngs = jax.random.split(jax.random.PRNGKey(3), H.B)
    jstate = jax.tree_util.tree_map(np.asarray, jax.jit(jwrapped.reset)(rngs))
    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(
        H.torch_env(), H.EPISODE_LENGTH,
        randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )
    draws = {k: torch.from_numpy(v) for k, v in _jax_reset_draws(jenv, rngs).items()}
    return jstate, twrapped.reset_from_draws(draws)


def test_reset_matches_jax(resets):
    jstate, tstate = resets
    ji, ti = jstate.info, tstate.info
    np.testing.assert_array_equal(tstate.qpos.numpy(), jstate.pipeline_state.qpos)
    np.testing.assert_array_equal(tstate.qvel.numpy(), jstate.pipeline_state.qvel)
    np.testing.assert_allclose(tstate.obs.numpy(), jstate.obs, atol=2e-6)
    np.testing.assert_array_equal(ti["command"].numpy(), ji["command"])
    np.testing.assert_allclose(ti["desired_world_z_in_body_frame"].numpy(),
                               ji["desired_world_z_in_body_frame"], atol=1e-7)
    np.testing.assert_allclose(ti["imu_buffer"].numpy(), ji["imu_buffer"], atol=2e-6)
    for name in ("last_act", "action_buffer", "last_vel", "feet_air_time", "kick",
                 "last_contact", "step", "steps", "truncation"):
        np.testing.assert_array_equal(ti[name].numpy(), ji[name], err_msg=name)
    np.testing.assert_array_equal(ti["first_qpos"].numpy(), ji["first_qpos"])
    np.testing.assert_array_equal(ti["first_qvel"].numpy(), ji["first_qvel"])
    np.testing.assert_array_equal(ti["first_obs"].numpy(), tstate.obs.numpy())
    for name in ("reward", "done"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), getattr(jstate, name))
    assert set(tstate.metrics) == set(jstate.metrics)
    assert set(ti["rewards"]) == set(ji["rewards"])


def test_reset_draws_shapes_and_ranges():
    env = PupperV3Env(device="cpu")
    n = 256
    d = env.draw_reset(H.env_keys(n, seed=1))
    c = env._start_position_config
    q = d["qpos"]
    assert q.shape == (n, 19) and q.dtype == torch.float32
    for i, (lo, hi) in enumerate(((c.x_min, c.x_max), (c.y_min, c.y_max), (c.z_min, c.z_max))):
        assert lo <= q[:, i].min() and q[:, i].max() <= hi
    torch.testing.assert_close(q[:, 3:7].norm(dim=1), torch.ones(n))
    assert (q[:, 4:6] == 0).all()  # a pure yaw
    np.testing.assert_array_equal(q[:, 7:].numpy(), np.tile(env._init_q[7:], (n, 1)))
    assert d["command"].shape == (n, 3)
    assert d["command"][:, 0].abs().max() <= 0.75 and d["command"][:, 2].abs().max() <= 2.0
    torch.testing.assert_close(d["desired_z"], torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3))
    assert d["imu_lat"].shape == (n, 2) and (d["imu_lat"].sum(1) == 1).all()


def test_step_noise_shapes_and_ranges():
    env = PupperV3Env(maximum_pitch_command=10.0, device="cpu")
    n = 512
    d = env.draw_step_noise(H.env_keys(n, seed=2))
    assert set(d) == set(env._CORE_NOISE_KEYS) | {"rng"} and d["rng"].shape == (n, 2)
    assert d["kick"].shape == (n, 2) and d["kick"].abs().max() <= 0.2
    assert 0 < (d["kick"] != 0).any(1).float().mean() < 0.1  # kick_probability 0.02
    for name, depth in (("act_lat", 2), ("imu_lat", 2)):
        assert d[name].shape == (n, depth) and (d[name].sum(1) == 1).all()
    # latency 0 with probability 0.2 (actions) and 0.5 (IMU)
    assert 0.1 < d["act_lat"][:, 0].mean() < 0.3
    assert 0.35 < d["imu_lat"][:, 0].mean() < 0.65
    assert d["motor_ang_noise"].shape == (n, 12) and d["motor_ang_noise"].abs().max() <= 0.1
    torch.testing.assert_close(d["resample_ori"].norm(dim=1), torch.ones(n))
    assert (d["resample_ori"][:, 2] < 1).any()  # the pitch command tilts it


def test_domain_randomize_contract():
    env = PupperV3Env(device="cpu")
    n = 64
    cfg = DomainRandomizationConfig()
    m = domain_randomize(env.model, H.env_keys(n, seed=3),
                         **{k: v for k, v in vars(cfg).items() if k != "enabled"})
    fr = m.geom_friction
    assert fr.shape == (n,) + env.model.geom_friction.shape
    # one friction scalar per env, on every geom's slide friction
    assert (fr[:, :, 0] == fr[:, :1, 0]).all()
    assert 0.6 <= fr[:, 0, 0].min() and fr[:, 0, 0].max() <= 1.4
    np.testing.assert_array_equal(fr[:, :, 1:].numpy(),
                                  np.broadcast_to(env.model.geom_friction[:, 1:], fr[:, :, 1:].shape))
    gain, bias = m.actuator_gainprm, m.actuator_biasprm
    assert (bias[:, :, 1] == -gain[:, :, 0]).all()
    kp = gain[:, :, 0] / 5.0
    assert 0.75 <= kp.min() and kp.max() <= 1.25 and (kp == kp[:, :1]).all()
    kd = -bias[:, :, 2] / 0.25
    assert 0.5 <= kd.min() and kd.max() <= 2.0 and (kd == kd[:, :1]).all()
    shift = m.body_ipos[:, 1] - torch.from_numpy(env.model.body_ipos[1])
    assert shift[:, 0].abs().max() <= 0.03 + 1e-7 and shift[:, 1].abs().max() <= 0.01 + 1e-7
    others = [b for b in range(env.model.nbody) if b != 1]
    np.testing.assert_array_equal(m.body_ipos[:, others].numpy(),
                                  np.broadcast_to(env.model.body_ipos[others], (n, len(others), 3)))
    ratio = m.body_mass[:, 1:] / torch.from_numpy(env.model.body_mass[1:])
    assert 0.7 - 1e-6 <= ratio.min() and ratio.max() <= 1.3 + 1e-6


def test_observation_size_and_config():
    env = PupperV3Env.from_config(EnvConfig(), device="cpu")
    assert env.observation_size == 72 and env.action_size == 12
    assert env._n_substeps == 5


@pytest.mark.parametrize("option", [
    {"privileged_obs": True}, {"disturbance_curriculum": True}, {"path": "other.xml"},
])
def test_unported_options_raise(option):
    """Another MJCF, ported since, builds from its committed tables
    (``test_torch_capsule.py``), and a file that is not there raises; the
    privileged obs and the disturbance curriculum, ported since, build an
    env that publishes them at reset (their parity:
    ``test_torch_privileged.py``, ``test_torch_extras.py``)."""
    if "path" in option:
        with pytest.raises(FileNotFoundError, match="other.xml"):
            PupperV3Env(device="cpu", **option)
        return
    env = PupperV3Env(device="cpu", **option)
    info = env.reset(H.env_keys(4)).info
    if "privileged_obs" in option:
        assert env.privileged_obs_size == 34 and info["privileged_obs"].shape == (4, 34)
        assert "difficulty" not in info
    else:
        assert torch.equal(info["difficulty"], torch.ones(4)) and "privileged_obs" not in info


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    """With no device argument the env, the networks, the normalizer and the
    learner run on ``cuda:0``; without a CUDA device they raise instead of
    falling back to the CPU."""
    from puppax_torch.train import networks, ppo, running_statistics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (PupperV3Env, lambda: networks.make_ppo_networks(72, 12),
                  lambda: running_statistics.init_state(72),
                  lambda: ppo.train(None, 8, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert PupperV3Env(device="cpu").device == torch.device("cpu")


def test_unported_terrain_and_action_repeat_raise(monkeypatch):
    """A terrain builds from its committed tables (run8's boxes,
    ``test_torch_obstacles.py``; run9's heightfield,
    ``test_torch_terrain.py``) and raises without them, naming the command
    that writes them; the physics-only lane builds run8 (K1 on a box static,
    ``test_torch_box_lanes.py``); ``action_repeat``,
    ported since, keeps training on the standard lane with JAX's reason
    (``test_torch_extras.py``)."""
    from puppax_torch.env.rollout import support_reason

    with pytest.raises(FileNotFoundError, match="puppax_torch.model.tables --config"):
        PupperV3Env.from_config(EnvConfig(n_obstacles=3), device="cpu")
    assert len(PupperV3Env.from_config(EnvConfig(n_obstacles=20), device="cpu")
               .model.pairs_sphere_box) == 160
    monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
    po = PupperV3Env.from_config(EnvConfig(n_obstacles=20), device="cpu")
    assert not po._use_soa_env and po._cv_step.s.boxes.n == 20
    monkeypatch.delenv("PUPPAX_SOA_ENV")
    env = PupperV3Env.from_config(EnvConfig(heightfield=True), device="cpu")
    assert env.model.pairs_hfield_sphere
    with pytest.raises(FileNotFoundError, match="puppax_torch.model.tables --config"):
        PupperV3Env.from_config(EnvConfig(heightfield=True, heightfield_seed=5), device="cpu")
    wrapped = wrap_for_training(PupperV3Env(device="cpu"), 1000, action_repeat=2)
    assert support_reason(wrapped) == (False, "action_repeat=2 (kernel fuses 1)")
