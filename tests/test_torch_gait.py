"""The gait clock (``gait_phase_observation=True``) against puppax, in every lane.

The clock runs outside the step core: ``info["gait_phase"]`` ticks by the
float32 ``2 pi f dt`` modulo 2 pi each step, its (cos, sin) follow the
history stack in the observation, and AutoReset restarts it on the
effective done (termination or the episode limit). Held against puppax's
wrapped env with the clock on, over 2 steps from a state where env 0 starts
past a joint limit (a termination), env 1 enters done (the AutoReset
prologue), envs 2-3 reach the episode limit (truncation), and the clocks
start apart, some just short of 2 pi (the wrap):

* the standard lane (K2's plain version) and the physics-only lane
  (``PUPPAX_SOA_ENV=off``) against ``puppax``'s wrapped ``step``;
* the fast lane, through K3 and through K4 (``PUPPAX_FUSED_UNROLL=on``),
  against ``puppax``'s ``FastLane(mode="xla")``.

The clock and its obs columns at 1e-6; the rest of the observation at 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import domain_randomization as jdr
from puppax.env import rollout as jrollout
from puppax.env import wrappers as jwrappers
from puppax.configs import get_config
from puppax.train import networks as jnets
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.train import networks as tnets

torch.set_num_threads(1)

T = 2
OBS = 74  # 2 x 36 history + the clock's (cos, sin)
PHASE0 = np.linspace(0.5, 6.27, H.B).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_wrapped(episode_length):
    env = JaxEnv(path=None, reward_config=get_config(), gait_phase_observation=True,
                 **H.env_kwargs(1))
    return env, jwrappers.wrap_for_training(
        env, episode_length, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B),
    )


def _torch_wrapped(jwrapped, episode_length):
    leaves = H.dr_leaves(jwrapped.env._model)
    return wrap_for_training(
        PupperV3Env(device="cpu", gait_phase_observation=True, **H.env_kwargs(1)),
        episode_length, randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )


def _start(jwrapped, episode_length, terminate_env0):
    jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), H.B))
    assert (np.asarray(jstate.obs)[:, 72:] == [1.0, 0.0]).all()
    steps = np.zeros(H.B, np.float32)
    steps[2:4] = episode_length - 1
    done = np.zeros(H.B, np.float32)
    done[1] = 1.0
    qpos = np.array(jstate.pipeline_state.qpos)
    if terminate_env0:
        qpos[0, 7] = jwrapped.env.lowers[0] - 0.4
    return jstate.replace(
        done=jnp.asarray(done),
        info=dict(jstate.info, steps=jnp.asarray(steps), gait_phase=jnp.asarray(PHASE0)),
        pipeline_state=jstate.pipeline_state.replace(qpos=jnp.asarray(qpos)),
    )


def _check_clock(got_phase, got_obs, want_phase, want_obs, what):
    np.testing.assert_allclose(got_phase, want_phase, rtol=0, atol=1e-6, err_msg=f"{what} phase")
    np.testing.assert_allclose(got_obs[..., 72:], want_obs[..., 72:], rtol=0, atol=1e-6,
                               err_msg=f"{what} clock columns")
    np.testing.assert_allclose(got_obs, want_obs, rtol=0, atol=2e-4, err_msg=f"{what} obs")


def test_reset_and_sizes():
    env = PupperV3Env(device="cpu", gait_phase_observation=True, **H.env_kwargs(1))
    assert env.observation_size == OBS
    state = wrap_for_training(env, 5).reset(H.env_keys(H.B))
    assert state.obs.shape == (H.B, OBS)
    assert torch.equal(state.info["gait_phase"], torch.zeros(H.B))
    assert torch.equal(state.obs[:, 72:], torch.tensor([[1.0, 0.0]]).expand(H.B, 2))
    assert torch.equal(state.info["first_obs"], state.obs)


@pytest.fixture(scope="module")
def standard():
    """puppax's wrapped step with the clock on: its start state and draws,
    and its 2 steps."""
    L = 3
    jenv, jwrapped = _jax_wrapped(L)
    jstate = _start(jwrapped, L, terminate_env0=True)
    start = _np(jstate)
    jstep = jax.jit(jwrapped.step)
    draw = jax.jit(jax.vmap(jenv._draw_step_noise))
    rng = np.random.RandomState(9)
    noises, acts, jstates = [], [], []
    for _ in range(T):
        noises.append({k: torch.from_numpy(np.array(v)) for k, v in
                       draw(jstate.info["rng"]).items() if k in jenv._CORE_NOISE_KEYS})
        acts.append(rng.uniform(-1, 1, (H.B, 12)).astype(np.float32))
        jstate = jstep(jstate, jnp.asarray(acts[-1]))
        jstates.append(_np(jstate))
    return L, jwrapped, start, noises, acts, jstates


@pytest.mark.parametrize("lane", ["k2", "physics-only"])
def test_standard_lanes_match_jax(standard, lane, monkeypatch):
    L, jwrapped, start, noises, acts, jstates = standard
    if lane == "physics-only":
        monkeypatch.setenv("PUPPAX_SOA_ENV", "off")  # read at the env's construction
    twrapped = _torch_wrapped(jwrapped, L)
    assert twrapped.env._use_soa_env == (lane == "k2")
    state = state_from_jax(start)
    for t, (noise, act, j) in enumerate(zip(noises, acts, jstates)):
        state = twrapped.step_from_draws(state, torch.from_numpy(act), noise)
        what = f"{lane} step {t}"
        np.testing.assert_array_equal(state.done.numpy(), j.done, err_msg=what)
        _check_clock(state.info["gait_phase"].numpy(), state.obs.numpy(),
                     j.info["gait_phase"], j.obs, what)
        if t == 0:
            # the termination (env 0) and the truncations (envs 2-3) restart
            # the clock; the prologue (env 1) and the others tick on
            assert (j.done[[0, 2, 3]] == 1).all() and j.info["truncation"][0] == 0
            assert (j.info["gait_phase"][[0, 2, 3]] == 0).all()
            assert (j.obs[[0, 2, 3], 72:] == [1.0, 0.0]).all()
            assert (j.info["gait_phase"][[1, 4, 5, 6, 7]] > 0).all()
    assert (jstates[-1].info["gait_phase"] < PHASE0).any()  # a clock wrapped past 2 pi


@pytest.fixture(scope="module")
def fast_lanes():
    """puppax's xla fast lane with the clock on, and the port's K3 and K4
    lanes on its draws."""
    L = H.EPISODE_LENGTH
    jenv, jwrapped = _jax_wrapped(L)
    jstate = _start(jwrapped, L, terminate_env0=False)
    nets = jnets.make_ppo_networks(OBS, 12, policy_hidden_layer_sizes=(32, 32),
                                   activation=jax.nn.elu)
    params = nets.policy_network.init(jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(11)
    jlane = jrollout.FastLane(jwrapped, mode="xla")
    jfinal, jdata = _np(jlane.unroll(jstate, (None, params), key, T, jax.nn.elu))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, : H.B]

    def key_step(k, _):
        cur, nxt = jax.random.split(k)
        return nxt, cur

    _, used = jax.lax.scan(key_step, key, (), length=T)
    eps = np.array(jax.vmap(lambda k: jax.random.normal(k, (H.B, 12)))(used))

    tlane = FastLane(_torch_wrapped(jwrapped, L))
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
    return jfinal, jdata, out


@pytest.mark.parametrize("lane", ["k3", "k4"])
def test_fast_lanes_match_jax(fast_lanes, lane):
    jfinal, jdata, out = fast_lanes
    tfinal, tdata = out[lane]
    _check_clock(tfinal.info["gait_phase"].numpy(), tfinal.obs.numpy(),
                 jfinal.info["gait_phase"], jfinal.obs, f"{lane} final")
    for name in ("observation", "next_observation"):
        got, want = getattr(tdata, name).numpy(), getattr(jdata, name)
        np.testing.assert_allclose(got[..., 72:], want[..., 72:], rtol=0, atol=1e-6,
                                   err_msg=f"{lane} {name} clock columns")
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4, err_msg=f"{lane} {name}")
    np.testing.assert_allclose(tdata.action.numpy(), jdata.action, atol=2e-4)
    np.testing.assert_array_equal(tdata.discount.numpy(), jdata.discount)
    # the truncated envs (2-3) restart the clock: the next observation shows
    # phase 0 after step 0
    assert (jdata.truncation[0, 2:4] == 1).all()
    assert (jdata.next_observation[0, 2:4, 72:] == [1.0, 0.0]).all()
