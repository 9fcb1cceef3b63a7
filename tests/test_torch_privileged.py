"""run12's env (history 4, privileged obs, gait clock, disturbance
curriculum) against puppax, in every lane.

The privileged obs (``PupperV3Env._privileged_observation``, 34 rows: the
torso's true local velocities and gravity, the joint velocities, the
contact flags, the feet air times, the kick and the DR leaves) is computed
in torch on the standard lane and emitted as aux rows by the wrapped step
(K3, K4), restored on done from the ``first`` block. The curriculum's
difficulty scales the step's five disturbance draws. Held against puppax's
env built with the same options, 1 physics substep, 8 envs with DR:

* the emission at history 4: the plain wrapped step (K3's program, its
  privileged rows and their restore) against ``wrapped_step_rows_xla``, and
  the plain K2 rows against the XLA step core;
* the reset's privileged obs and difficulty, on puppax's reset draws, and
  ``_privileged_observation`` at reset and after a step in float64 on
  puppax's physics state;
* the standard lanes (K2's plain version and the physics-only lane) over 2
  wrapped steps against puppax's wrapped ``step``, the difficulty apart per
  env (0 to 1), from a state where env 0 starts past a joint limit, env 1
  enters done and envs 2-3 reach the episode limit;
* the fast lane through K3 and through K4 (``unroll_rows``) over 3 steps
  with episodes of 3 steps (every env ends inside the unroll, several more
  than once) against puppax's ``FastLane(mode="xla")`` run with the
  difficulty, fed its unscaled draws: the observations, the transitions'
  ``privileged_obs`` / ``next_privileged_obs`` extras and the final state.

Tolerances: ``torch_port_helpers.assert_privileged_close`` for the
privileged rows (velocities as qvel, 5e-4 scaled; gravity 2e-4; contact
exact; air time 1e-5; kick and DR leaves 1e-6 relative), obs and reward
2e-4, done exact, the rest as ``tests/test_soa.py:199-204``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_env_step as ES
import torch_port_helpers as H
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import domain_randomization as jdr
from puppax.env import rollout as jrollout
from puppax.env import soa_env as jax_soa_env
from puppax.env import wrappers as jwrappers
from puppax.train import networks as jnets
from puppax_torch.env import soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane, support_reason
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.train import networks as tnets

torch.set_num_threads(1)

OBS = 4 * 36 + 2  # history 4 and the clock's (cos, sin)
PHASE0 = np.linspace(0.5, 6.27, H.B).astype(np.float32)
DIFFICULTY = np.linspace(0.0, 1.0, H.B).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


L = 3  # episode length of the wrapped runs: every env ends within 3 steps
# run12's env, kicked often so the difficulty's scaling of the kick shows
KW = dict(H.run12_kwargs(1), kick_probability=0.6)


@pytest.fixture(scope="module")
def jax_run12():
    """puppax's wrapped run12 env and its reset (jitted once)."""
    env = JaxEnv(path=None, reward_config=get_config(), **KW)
    wrapped = jwrappers.wrap_for_training(
        env, L, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B),
    )
    rngs = jax.random.split(jax.random.PRNGKey(3), H.B)
    return env, wrapped, rngs, jax.jit(wrapped.reset)(rngs)


def _torch_wrapped(jwrapped):
    leaves = H.dr_leaves(jwrapped.env._model)
    return wrap_for_training(
        PupperV3Env(device="cpu", **KW), L,
        randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )


def _start(jwrapped, jstate):
    """puppax's reset with env 0 past a joint limit, env 1 done, envs 2-3 at
    the episode limit, the clocks apart and the difficulty from 0 to 1."""
    episode_length = L
    steps = np.zeros(H.B, np.float32)
    steps[2:4] = episode_length - 1
    done = np.zeros(H.B, np.float32)
    done[1] = 1.0
    qpos = np.array(jstate.pipeline_state.qpos)
    qpos[0, 7] = jwrapped.env.lowers[0] - 0.4
    return jstate.replace(
        done=jnp.asarray(done),
        info=dict(jstate.info, steps=jnp.asarray(steps), gait_phase=jnp.asarray(PHASE0),
                  difficulty=jnp.asarray(DIFFICULTY)),
        pipeline_state=jstate.pipeline_state.replace(qpos=jnp.asarray(qpos)),
    )


# ---- the emission at history 4 ----------------------------------------------


def test_support_and_statics():
    env = PupperV3Env(device="cpu", **H.run12_kwargs(1))
    assert env.observation_size == OBS and env.privileged_obs_size == 34
    assert env._es.priv and env._es.npriv == 34 and env._es.hist == 144
    assert soa_env.aux_row_map(env._es)["privileged"] == (22, 34)
    assert soa_env.block_rows(env._s, env._es)[0][6] == env._s.nq + env._s.nv + 144 + 34
    assert support_reason(wrap_for_training(env, 5)) == (True, "ok")
    # the K2 body carries no privileged rows (JAX's standard lane computes them outside)
    from puppax_torch.kernels import cgen

    plain = PupperV3Env(device="cpu", **dict(H.env_kwargs(1), observation_history=4))
    assert not plain._es.priv
    assert cgen.env_step_body(env._s, env._es, 1) == cgen.env_step_body(plain._s, plain._es, 1)


def test_wrapped_step_rows_matches_xla_with_privileged_rows():
    jenv = JaxEnv(path=None, reward_config=get_config(), **H.run12_kwargs(1))
    tenv = PupperV3Env(device="cpu", **H.run12_kwargs(1))
    js, jes = jenv._cv_core._s, jenv._cv_core._es
    s, es = tenv._s, tenv._es
    assert jes.priv and jes.npriv == es.npriv and jes.hist == es.hist
    blocks = H.wrapped_step_blocks(s, es, tenv.model, H.jax_dr_rows(js, H.jax_dr_model(jenv)),
                                   np.random.RandomState(0))
    want = [np.asarray(w) for w in jax_soa_env.wrapped_step_rows_xla(
        js, jes, 1, H.EPISODE_LENGTH, *[np.asarray(b) for b in blocks])]
    got = [g.numpy() for g in soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH,
                                                        *H.to_torch(blocks))]
    aux_rows = soa_env.aux_row_map(es)
    assert aux_rows == jax_soa_env.aux_row_map(jes)
    H.assert_wrapped_outputs_close(got, want, s, es, aux_rows, "history 4 + privileged")
    # the restore on done: the privileged rows are the first block's
    done = want[3][1] > 0.5
    assert done[[2, 3]].all() and not done.all()
    r0, n = aux_rows["privileged"]
    f0 = s.nq + s.nv + es.hist
    np.testing.assert_array_equal(got[4][r0 : r0 + n][:, done], blocks[6][f0 : f0 + n][:, done])


def test_env_step_rows_history4_matches_xla_step_core():
    kw = dict(H.env_kwargs(1), observation_history=4)
    jenv = JaxEnv(path=None, reward_config=get_config(), **kw)
    tenv = PupperV3Env(device="cpu", **kw)
    s, es = tenv._s, tenv._es
    dr = H.jax_dr_rows(jenv._cv_core._s, jenv.model)
    blocks = H.env_step_blocks(s, es, tenv.model, dr, np.random.RandomState(3))
    q, v, act, env_b, noi = blocks[:5]
    core = jax.jit(jax.vmap(lambda *a: jenv._step_core(jenv.model, *a)))
    ps, env_out = _np(core(q.T, v.T, act.T, ES._env_in(es, env_b), ES._noise_dict(es, noi)))
    got = soa_env.env_step_rows(s, es, 1, *H.to_torch(blocks))
    want = [ps.qpos.T, ps.qvel.T, ES._cache_block(s, ps), ES._out_block(es, env_out)]
    H.assert_env_outputs_close([g.numpy() for g in got], want, s, es, "K2 rows, history 4")


# ---- the env layer: reset and the standard lanes ------------------------------


@pytest.fixture(scope="module")
def standard(jax_run12):
    """puppax's wrapped run12 env: its start state, draws and 2 steps."""
    jenv, jwrapped, _, jreset = jax_run12
    jstate = _start(jwrapped, jreset)
    start = _np(jstate)
    jstep = jax.jit(jwrapped.step)
    draw = jax.jit(jax.vmap(jenv._draw_step_noise))
    rng = np.random.RandomState(9)
    noises, acts, jstates = [], [], []
    for _ in range(2):
        noises.append({k: torch.from_numpy(np.array(v)) for k, v in
                       draw(jstate.info["rng"]).items() if k in jenv._CORE_NOISE_KEYS})
        acts.append(rng.uniform(-1, 1, (H.B, 12)).astype(np.float32))
        jstate = jstep(jstate, jnp.asarray(acts[-1]))
        jstates.append(_np(jstate))
    return jwrapped, start, noises, acts, jstates


def test_reset_matches_jax(jax_run12):
    """The reset's privileged obs and difficulty on puppax's reset draws;
    AutoReset keeps the privileged obs as ``first_privileged_obs``."""
    from test_torch_env import _jax_reset_draws

    jenv, jwrapped, rngs, jstate = jax_run12
    jstate = _np(jstate)
    draws = {k: torch.from_numpy(v) for k, v in _jax_reset_draws(jenv, rngs).items()}
    state = _torch_wrapped(jwrapped).reset_from_draws(draws)
    H.assert_privileged_close(state.info["privileged_obs"].numpy(),
                              jstate.info["privileged_obs"], "reset")
    assert torch.equal(state.info["first_privileged_obs"], state.info["privileged_obs"])
    assert torch.equal(state.info["difficulty"], torch.ones(H.B))
    np.testing.assert_array_equal(jstate.info["difficulty"], np.ones(H.B, np.float32))
    # the DR leaves are each env's own
    assert len(np.unique(jstate.info["privileged_obs"][:, 31])) == H.B
    np.testing.assert_allclose(state.obs.numpy(), jstate.obs, rtol=0, atol=2e-4)


@pytest.mark.parametrize("when", ["reset", "step"])
def test_privileged_observation_float64(standard, when):
    """``_privileged_observation`` in float64 on puppax's physics state (at
    reset, and after a step) against puppax's float32 value."""
    jwrapped, start, noises, acts, jstates = standard
    j = start if when == "reset" else jstates[0]
    env = PupperV3Env(device="cpu", **KW)
    ps, info = j.pipeline_state, j.info
    t = env._torso_idx - 1
    f64 = lambda x: torch.from_numpy(np.asarray(x, np.float64))  # noqa: E731
    model = _torch_wrapped(jwrapped).model
    got = env._privileged_observation(
        model, f64(ps.x_rot[:, t]), f64(ps.xd_vel[:, t]), f64(ps.xd_ang[:, t]),
        f64(ps.qd[:, 6:]) if hasattr(ps, "qd") else f64(ps.qvel[:, 6:]),
        {"last_contact": torch.from_numpy(np.array(info["last_contact"])),
         "feet_air_time": f64(info["feet_air_time"])}, f64(info["kick"]))
    assert got.dtype == torch.float64
    want = info["privileged_obs"]
    if when == "step":  # the restored envs hold the reset's value
        live = j.done < 0.5
        got, want = got[torch.from_numpy(live)], want[live]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lane", ["k2", "physics-only"])
def test_standard_lanes_match_jax(standard, lane, monkeypatch):
    jwrapped, start, noises, acts, jstates = standard
    if lane == "physics-only":
        monkeypatch.setenv("PUPPAX_SOA_ENV", "off")  # read at the env's construction
    twrapped = _torch_wrapped(jwrapped)
    assert twrapped.env._use_soa_env == (lane == "k2")
    state = state_from_jax(start)
    assert torch.equal(state.info["difficulty"], torch.from_numpy(DIFFICULTY))
    for t, (noise, act, j) in enumerate(zip(noises, acts, jstates)):
        state = twrapped.step_from_draws(state, torch.from_numpy(act), noise)
        what = f"{lane} step {t}"
        np.testing.assert_array_equal(state.done.numpy(), j.done, err_msg=what)
        np.testing.assert_allclose(state.obs.numpy(), j.obs, rtol=0, atol=2e-4, err_msg=what)
        np.testing.assert_allclose(state.reward.numpy(), j.reward, rtol=0, atol=2e-4,
                                   err_msg=what)
        # the kick after the difficulty's scaling, and in the privileged obs
        np.testing.assert_allclose(state.info["kick"].numpy(), j.info["kick"], rtol=1e-6,
                                   atol=0, err_msg=what)
        H.assert_privileged_close(state.info["privileged_obs"].numpy(),
                                  j.info["privileged_obs"], what)
        if t == 0:
            done = j.done > 0.5
            assert done[[0, 2, 3]].all() and not done.all()
            np.testing.assert_array_equal(j.info["privileged_obs"][done],
                                          start.info["first_privileged_obs"][done])
    assert torch.equal(state.info["difficulty"], torch.from_numpy(DIFFICULTY))
    kicked = np.abs(np.stack([n["kick"].numpy() for n in noises])).sum(-1) > 0
    assert kicked[:, 1:-1].any(), "no env between difficulty 0 and 1 was kicked"


# ---- the fast lane: K3 and K4 ------------------------------------------------


@pytest.fixture(scope="module")
def fast_lanes(jax_run12):
    """puppax's xla fast lane on run12's env with the difficulty, and the
    port's K3 and K4 lanes on its unscaled draws."""
    T = 3
    _, jwrapped, _, jreset = jax_run12
    jstate = _start(jwrapped, jreset)
    nets = jnets.make_ppo_networks(OBS, 12, policy_hidden_layer_sizes=(32, 32),
                                   activation=jax.nn.elu)
    params = nets.policy_network.init(jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(11)
    jlane = jrollout.FastLane(jwrapped, mode="xla")
    jfinal, jdata = _np(jlane.unroll(jstate, (None, params), key, T, jax.nn.elu,
                                     difficulty=jstate.info["difficulty"]))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)  # unscaled
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, : H.B]

    def key_step(k, _):
        cur, nxt = jax.random.split(k)
        return nxt, cur

    _, used = jax.lax.scan(key_step, key, (), length=T)
    eps = np.array(jax.vmap(lambda k: jax.random.normal(k, (H.B, 12)))(used))

    tlane = FastLane(_torch_wrapped(jwrapped))
    policy = tnets.make_ppo_networks(OBS, 12, (32, 32), (32, 32), device="cpu").policy_network
    policy.load_state_dict(tnets.params_from_jax(_np(params)))
    draws = (torch.from_numpy(noise.copy()), torch.from_numpy(eps),
             torch.from_numpy(np.array(last_kick)))
    tstate = state_from_jax(_np(jstate))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        out["k3"] = tlane.unroll_from_draws(tstate, (None, policy), *draws)
        mp.setenv("PUPPAX_FUSED_UNROLL", "on")
        out["k4"] = tlane.unroll_from_draws(tstate, (None, policy), *draws)
    return _np(jstate), jfinal, jdata, out


@pytest.mark.parametrize("lane", ["k3", "k4"])
def test_fast_lanes_match_jax(fast_lanes, lane):
    jstart, jfinal, jdata, out = fast_lanes
    tfinal, tdata = out[lane]
    for name in ("observation", "next_observation"):
        np.testing.assert_allclose(getattr(tdata, name).numpy(), getattr(jdata, name), rtol=0,
                                   atol=2e-4, err_msg=f"{lane} {name}")
    np.testing.assert_array_equal(tdata.discount.numpy(), jdata.discount)
    np.testing.assert_array_equal(tdata.truncation.numpy(), jdata.truncation)
    np.testing.assert_allclose(tdata.reward.numpy(), jdata.reward, rtol=0, atol=2e-4)
    assert set(tdata.extras) == set(jdata.extras) == {"privileged_obs", "next_privileged_obs"}
    for name in tdata.extras:
        for t in range(tdata.extras[name].shape[0]):
            H.assert_privileged_close(tdata.extras[name][t].numpy(), jdata.extras[name][t],
                                      f"{lane} {name} step {t}")
    # step 0's pre-step value is the entry state's
    np.testing.assert_array_equal(tdata.extras["privileged_obs"][0].numpy(),
                                  jstart.info["privileged_obs"])
    # every env ends inside the unroll, and its rows are restored to the reset's
    done = 1.0 - jdata.discount > 0.5
    assert done.any(0).all()
    first = jstart.info["first_privileged_obs"]
    for t in range(done.shape[0]):
        np.testing.assert_array_equal(tdata.extras["next_privileged_obs"][t].numpy()[done[t]],
                                      first[done[t]])
    H.assert_privileged_close(tfinal.info["privileged_obs"].numpy(),
                              jfinal.info["privileged_obs"], f"{lane} final")
    np.testing.assert_allclose(tfinal.obs.numpy(), jfinal.obs, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tfinal.info["kick"].numpy(), jfinal.info["kick"], rtol=1e-6,
                               atol=0)
    assert torch.equal(tfinal.info["difficulty"], torch.from_numpy(DIFFICULTY))
