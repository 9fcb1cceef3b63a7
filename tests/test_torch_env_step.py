"""The standard lane: the unwrapped env step (K2's plain version), the
wrapped step around it, and the lane against the rollout fast lane.

* ``env_step_rows`` (the K2 emission plus the last forward pass's caches,
  evaluated with torch ops) against ``puppax``'s XLA step core
  ``PupperV3Env._step_core`` (vmapped) on random states, at the tolerances
  of ``tests/test_soa_env.py:131-193``; the caches against the
  PhysicsState the core returns, at ``CACHE_ATOL`` / ``CACHE_SCALED``
  (``torch_port_helpers.py``).
* The wrapped ``step_from_draws`` over 2 steps against ``puppax``'s
  wrapped ``step`` (AutoReset(Vmap(Episode(env))) with DR) on the draws
  its key chain makes (``_draw_step_noise``): env 1 enters done (the
  AutoReset prologue), envs 2-3 reach the episode limit (truncation), and
  env 0 starts with a hip past its joint limit (a termination that
  restores the reset-time pipeline state; a start below the termination
  height would sink the feet into the floor, where the XLA path's contact
  caps part from the uncapped emission, ROADMAP queue 3).
* The port's standard lane against its own fast lane
  (``FastLane.unroll_from_draws``) on the same draws and actions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env import domain_randomization as jdr
from puppax.env import wrappers as jwrappers
from puppax_torch import random
from puppax_torch.env import soa_env
from puppax_torch.env.base import physics_state_from_caches, state_from_jax
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.train import networks as tnets
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

L = 3  # episode length of the wrapped tests: envs 2-3 truncate on step 1


def _env_in(es, env_block):
    """The JAX step core's env_in dict of one ``(nenv_rows, B)`` block."""
    B = env_block.shape[1]
    shapes = {"action_buffer": (12, es.Da), "imu_buffer": (6, es.Di)}
    out = {}
    for name, (r0, n) in es.env_rows.items():
        x = env_block[r0 : r0 + n].T.reshape((B,) + shapes.get(name, (n,)))
        if name == "last_contact":
            x = x > 0.5
        elif name == "step":
            x = x[:, 0].astype(np.int32)
        out[name] = x
    return out


def _noise_dict(es, noise_block):
    return {name: noise_block[r0 : r0 + n].T for name, (r0, n) in es.noise_rows.items()}


def _cache_block(s, ps):
    """A JAX PhysicsState (numpy leaves) as the ``(ncache, B)`` block."""
    B = ps.qpos.shape[0]
    parts = {
        "qacc": ps.qacc, "xpos": ps.xpos, "xquat": ps.x_rot, "xd_ang": ps.xd_ang,
        "xd_vel": ps.xd_vel, "site_xpos": ps.site_xpos, "qfrc_actuator": ps.qfrc_actuator,
        "con_dist": ps.contact.dist, "con_pos": ps.contact.pos,
    }
    return np.concatenate([np.asarray(parts[name]).reshape(B, n)
                           for name, (_, n) in s.cache_rows.items()], 1).T


def _ps_block(ps):
    """The port's PhysicsState as the ``(ncache, B)`` block."""
    B = ps.qpos.shape[0]
    return torch.cat([x.reshape(B, -1) for x in (
        ps.qacc, ps.xpos, ps.x_rot, ps.xd_ang, ps.xd_vel, ps.site_xpos, ps.qfrc_actuator,
        ps.contact_dist, ps.contact_pos)], 1).t().numpy()


def _out_block(es, env_out):
    B = env_out["reward"].shape[0]
    parts = dict(env_out, obs_history=env_out["obs"],
                 rewards=np.stack([env_out["rewards"][k] for k in soa_env.REWARD_ORDER], 1))
    return np.concatenate([np.asarray(parts[name], np.float32).reshape(B, n)
                           for name, (_, n) in es.out_rows.items()], 1).T


def test_env_step_rows_matches_xla_step_core():
    jenv, tenv = H.jax_env(), H.torch_env()
    s, es = tenv._s, tenv._es
    dr = H.jax_dr_rows(jenv._cv_core._s, jenv.model)
    blocks = H.env_step_blocks(s, es, tenv.model, dr, np.random.RandomState(3))
    q, v, act, env_b, noi = blocks[:5]
    core = jax.jit(jax.vmap(lambda *a: jenv._step_core(jenv.model, *a)))
    ps, env_out = jax.tree_util.tree_map(np.asarray, core(
        q.T, v.T, act.T, _env_in(es, env_b), _noise_dict(es, noi)))
    got = soa_env.env_step_rows(s, es, 1, *H.to_torch(blocks))
    want = [ps.qpos.T, ps.qvel.T, _cache_block(s, ps), _out_block(es, env_out)]
    H.assert_env_outputs_close([g.numpy() for g in got], want, s, es, "env_step_rows vs XLA core")
    r0, n = es.out_rows["last_contact"]
    assert want[3][r0 : r0 + n].any(), "no foot touches the floor"
    r0, n = s.cache_rows["con_dist"]
    assert (want[2][r0 : r0 + n] < 0).any(), "no contact penetrates"


def test_env_step_wrapper_on_cpu_runs_plain():
    """``env_step`` on CPU tensors is the plain version, counts no launch,
    and refuses malformed blocks."""
    tenv = H.torch_env()
    s, es = tenv._s, tenv._es
    dr = tenv.dr_rows(H.B).numpy()
    blocks = H.to_torch(H.env_step_blocks(s, es, tenv.model, dr, np.random.RandomState(4)))
    before = soa_env.env_step.launches
    got = soa_env.env_step(s, es, 1, *blocks)
    for g, p in zip(got, soa_env.env_step_rows(s, es, 1, *blocks)):
        assert torch.equal(g, p)
    assert soa_env.env_step.launches == before
    assert [g.shape[0] for g in got] == list(soa_env.env_block_rows(s, es)[1])
    bad = list(blocks)
    bad[5] = bad[5].double()
    with pytest.raises(TypeError):
        soa_env.env_step(s, es, 1, *bad)
    with pytest.raises(ValueError):
        soa_env.env_step(s, es, 1, *blocks[:5])
    bad = list(blocks)
    bad[3] = bad[3][:-1]
    with pytest.raises(ValueError):
        soa_env.env_step(s, es, 1, *bad)


@pytest.fixture(scope="module")
def wrapped_pair():
    """The JAX wrapped env and the port's, with the same DR leaves, from
    the same reset state; env 1 enters done, envs 2-3 one step before the
    episode limit, env 0 with a hip past its lower joint limit."""
    jenv = H.jax_env()
    jwrapped = jwrappers.wrap_for_training(
        jenv, L, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B),
    )
    jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), H.B))
    steps = np.zeros(H.B, np.float32)
    steps[2:4] = L - 1
    done = np.zeros(H.B, np.float32)
    done[1] = 1.0
    qpos = np.array(jstate.pipeline_state.qpos)
    qpos[0, 7] = jenv.lowers[0] - 0.4
    jstate = jstate.replace(
        done=jnp.asarray(done), info=dict(jstate.info, steps=jnp.asarray(steps)),
        pipeline_state=jstate.pipeline_state.replace(qpos=jnp.asarray(qpos)),
    )
    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(
        H.torch_env(), L, randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )
    return jenv, jwrapped, jstate, twrapped


def test_wrapped_step_matches_jax(wrapped_pair):
    jenv, jwrapped, jstate, twrapped = wrapped_pair
    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    jstep = jax.jit(jwrapped.step)
    draw = jax.jit(jax.vmap(jenv._draw_step_noise))
    rng = np.random.RandomState(9)
    for t in range(2):
        noise = {k: torch.from_numpy(np.array(v)) for k, v in draw(jstate.info["rng"]).items()
                 if k in jenv._CORE_NOISE_KEYS}
        act = rng.uniform(-1, 1, (H.B, 12)).astype(np.float32)
        jstate = jstep(jstate, jnp.asarray(act))
        tstate = twrapped.step_from_draws(tstate, torch.from_numpy(act), noise)
        j = jax.tree_util.tree_map(np.asarray, jstate)
        what = f"step {t}"
        close = np.testing.assert_allclose
        np.testing.assert_array_equal(tstate.done.numpy(), j.done, err_msg=what)
        for name in ("steps", "truncation", "step", "last_contact"):
            np.testing.assert_array_equal(tstate.info[name].numpy(), j.info[name],
                                          err_msg=f"{what} {name}")
        close(tstate.qpos.numpy(), j.pipeline_state.qpos, atol=2e-4, err_msg=f"{what} qpos")
        close(tstate.obs.numpy(), j.obs, atol=2e-4, err_msg=f"{what} obs")
        close(tstate.reward.numpy(), j.reward, atol=1e-3, err_msg=f"{what} reward")
        for name in ("command", "desired_world_z_in_body_frame", "last_act", "kick",
                     "action_buffer", "imu_buffer", "feet_air_time"):
            close(tstate.info[name].numpy(), j.info[name], atol=2e-4, err_msg=f"{what} {name}")
        scale = np.maximum(1.0, np.abs(j.pipeline_state.qvel).max(1, keepdims=True))
        close(tstate.qvel.numpy() / scale, j.pipeline_state.qvel / scale, atol=1e-3,
              err_msg=f"{what} qvel")
        close(tstate.info["last_vel"].numpy() / scale[:, :1], j.info["last_vel"] / scale[:, :1],
              atol=1e-3, err_msg=f"{what} last_vel")
        close(tstate.metrics["total_dist"].numpy(), j.metrics["total_dist"], atol=1e-4)
        s = twrapped.env._s
        H.assert_cache_rows_close(_ps_block(tstate.pipeline_state),
                                  _cache_block(s, j.pipeline_state), s, what)
        if t == 0:
            # env 0 terminated (no truncation) and envs 2-3 truncated: all
            # three are back at their reset-time pipeline state
            assert j.done[0] == 1 and j.info["truncation"][0] == 0
            assert (j.info["truncation"][2:4] == 1).all()
            first = tstate.info["first_pipeline_state"]
            for i in (0, 2, 3):
                assert torch.equal(tstate.pipeline_state.xpos[i], first.xpos[i])
                assert torch.equal(tstate.qpos[i], first.qpos[i])


def test_standard_lane_matches_fast_lane(wrapped_pair):
    """The wrapped standard step (K2's program + the Python wrappers) and
    the fast lane (K3's program) agree on the same draws and actions. Both
    run the same emitted arithmetic on the CPU; the tolerance 1e-5 covers
    the two emissions' different CSE scopes."""
    *_, twrapped = wrapped_pair
    key_env, key_net, key_eps = random.split(random.key(21), 3).unbind(0)
    env = twrapped.env
    state = twrapped.reset(random.split(key_env, H.B), caches=True)
    steps = torch.zeros(H.B)
    steps[2:4] = L - 1
    done = torch.zeros(H.B)
    done[1] = 1.0
    state = state.replace(done=done, info=dict(state.info, steps=steps))
    nets = tnets.make_ppo_networks(env.observation_size, env.action_size, (32, 32), (32, 32),
                                   device="cpu", key=key_net)
    norm = tstats.init_state(env.observation_size, device="cpu")
    lane = FastLane(twrapped)
    T = 2
    _, noise, last_kick = lane.draw_noise_block(state.info["rng"], T)
    eps = lane.draw_eps(key_eps, H.B, T)
    fstate, fdata = lane.unroll_from_draws(state, (norm, nets.policy_network), noise, eps,
                                           last_kick)
    sstate = state
    close = lambda a, b, what: torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=what)  # noqa: E731
    for t in range(T):
        noise_t = {name: noise[t][r0 : r0 + n].t() for name, (r0, n) in env._es.noise_rows.items()}
        sstate = twrapped.step_from_draws(sstate, fdata.action[t], noise_t)
        assert torch.equal(sstate.done, 1.0 - fdata.discount[t])
        assert torch.equal(sstate.info["truncation"], fdata.truncation[t])
        close(sstate.reward, fdata.reward[t], f"reward {t}")
        close(sstate.obs, fdata.next_observation[t], f"next obs {t}")
    assert (fdata.truncation[0, 2:4] == 1).all()
    close(sstate.qpos, fstate.qpos, "qpos")
    close(sstate.qvel, fstate.qvel, "qvel")
    for name in ("steps", "step", "last_contact"):
        assert torch.equal(sstate.info[name], fstate.info[name]), name
    for name in ("command", "last_act", "last_vel", "feet_air_time", "action_buffer"):
        close(sstate.info[name], fstate.info[name], name)
    assert fstate.pipeline_state is None and sstate.pipeline_state is not None


def test_reset_caches_match_jax_pipeline_init(wrapped_pair):
    """``TrainingEnv.reset_from_draws(caches=True)`` keeps a reset-time
    PhysicsState: the forward pass at zero controls of the port's
    ``pipeline.pipeline_init`` on the DR batch, as puppax's reset runs it."""
    jenv, jwrapped, _, twrapped = wrapped_pair
    jstate = jax.tree_util.tree_map(
        np.asarray, jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), H.B)))
    tstate = state_from_jax(jstate)
    ps = twrapped.env.pipeline_init(tstate.qpos, tstate.qvel, twrapped.model)
    s = twrapped.env._s
    got = _ps_block(ps)
    H.assert_cache_rows_close(got, _cache_block(s, jstate.pipeline_state), s, "pipeline_init")
    # the same cache block through physics_state_from_caches round-trips
    again = physics_state_from_caches(s, tstate.qpos, tstate.qvel, torch.from_numpy(got))
    assert torch.equal(again.x_rot, ps.x_rot) and torch.equal(again.contact_pos, ps.contact_pos)
