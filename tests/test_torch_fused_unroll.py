"""The fused unroll (K4's plain version and the lane around it) against puppax.

* The fold and the head: the port's ``fold_normalizer`` + ``mlp_rows`` +
  ``policy_math`` against ``puppax.env.fused_unroll``'s ``fold_normalizer``
  + ``mlp_rows_flat`` + ``policy_math`` on a non-trivial normalizer, for
  each hidden activation (act/raw 1e-5, log-prob 2e-4, as
  ``tests/test_fused_unroll.py:89-99``); the activations and the head also
  in float64 at 1e-10 (JAX's MLP and fold run in float32 only).
* The plumbing: JAX's real ``build_unroll_kernel`` in Pallas interpret mode
  with ``tests/test_fused_unroll.py``'s stubbed emission, against the port's
  ``unroll_rows`` with the same stub in torch, gait clock off and on: the
  t-indexing, the carry, the done restore and the phase.
* The fused lane end to end: the port's ``FastLane`` with
  ``PUPPAX_FUSED_UNROLL=on`` against JAX's ``FastLane(mode="xla")`` on the
  draws of ``tests/test_torch_rollout.py`` (tolerances of that file), and
  against the port's own K3 lane on the same draws (the fold is the only
  difference).
* ``ppo.train`` trains on the fused lane on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_fused_unroll as jtest
import torch_port_helpers as H
from puppax.env import domain_randomization as jdr
from puppax.env import fused_unroll as jfused
from puppax.env import rollout as jrollout
from puppax.env import soa_env as jsoa_env
from puppax.env import wrappers as jwrappers
from puppax.train import networks as jnets
from puppax.train import running_statistics as jstats
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.train import networks as tnets
from puppax_torch.train import ppo
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

OBS, ACT = 72, 12
JAX_ACTIVATIONS = {
    "elu": jax.nn.elu, "relu": jax.nn.relu, "tanh": jnp.tanh, "sigmoid": jax.nn.sigmoid,
    # feature-major rows: the softmax runs over the features (axis 0)
    "softmax": lambda x: jax.nn.softmax(x, axis=0),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _policy(activation: str, obs: int = OBS, seed: int = 7):
    """A flax policy's parameters and the port's MLP carrying them."""
    jn = jnets.make_ppo_networks(obs, ACT, policy_hidden_layer_sizes=(32, 32),
                                 activation=jax.nn.elu)
    params = jn.policy_network.init(jax.random.PRNGKey(seed))
    tn = tnets.make_ppo_networks(obs, ACT, (32, 32), (32, 32), activation=activation,
                                 device="cpu")
    tn.policy_network.load_state_dict(tnets.params_from_jax(_np(params)))
    return params, tn.policy_network


@pytest.mark.parametrize("activation", fused_unroll.ACTIVATIONS)
def test_fold_and_head_match_jax(activation):
    params, policy = _policy(activation)
    rng = np.random.RandomState(0)
    mean = np.linspace(-0.2, 0.3, OBS).astype(np.float32)
    std = np.linspace(0.7, 1.4, OBS).astype(np.float32)
    jnorm = jstats.init_state(OBS).replace(mean=jnp.asarray(mean), std=jnp.asarray(std))
    tnorm = tstats.from_jax(mean, std)
    B = 64
    x = rng.normal(0, 1, (OBS, B)).astype(np.float32)
    eps = rng.normal(0, 1, (ACT, B)).astype(np.float32)

    jlayers = jfused.fold_normalizer(jnorm, params)
    h = jfused.mlp_rows_flat(jlayers, JAX_ACTIVATIONS[activation], jnp.asarray(x))
    j_act, j_raw, j_lp = jfused.policy_math([h[i] for i in range(ACT)],
                                            [h[ACT + i] for i in range(ACT)], list(eps))

    layers = fused_unroll.fold_normalizer(tnorm, policy)
    for (w, b), (jw, jb) in zip(layers, jlayers):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    ht = fused_unroll.mlp_rows(layers, activation, torch.from_numpy(x))
    act, raw, lp = fused_unroll.policy_math(ht[:ACT], ht[ACT:], torch.from_numpy(eps))
    np.testing.assert_allclose(torch.stack(act).numpy(), np.stack(j_act), atol=1e-5)
    np.testing.assert_allclose(torch.stack(raw).numpy(), np.stack(j_raw), atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=2e-4)


@pytest.fixture
def jax_x64():
    """float64 JAX for one test (the module's other tests run in float32)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("activation", fused_unroll.ACTIVATIONS)
def test_activation_and_head_match_jax_in_float64(activation, jax_x64):
    rng = np.random.RandomState(1)
    x = rng.normal(0, 2, (16, 32))
    np.testing.assert_allclose(
        fused_unroll.activate(activation, torch.from_numpy(x)).numpy(),
        np.asarray(JAX_ACTIVATIONS[activation](jnp.asarray(x))), rtol=0, atol=1e-10)
    # scale parameters and pre-tanh actions well inside softplus's threshold
    loc, sp, eps = (rng.normal(0, 1, (ACT, 32)) for _ in range(3))
    j_act, j_raw, j_lp = jfused.policy_math(*(list(jnp.asarray(a)) for a in (loc, sp, eps)))
    act, raw, lp = fused_unroll.policy_math(*(torch.from_numpy(a) for a in (loc, sp, eps)))
    assert lp.dtype == torch.float64
    np.testing.assert_allclose(torch.stack(act).numpy(), np.stack(j_act), rtol=0, atol=1e-10)
    np.testing.assert_allclose(torch.stack(raw).numpy(), np.stack(j_raw), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), rtol=0, atol=1e-10)


def _torch_stub_emission(s, es, q, v, act, env, noi, dr, first_q, first_v, first_obs,
                         first_priv, steps, prev_done, n_substeps, episode_length):
    """``tests/test_fused_unroll.py::_stub_emission`` in torch, with the
    port's emission signature (the privileged rows unused, as there)."""
    nu = s.nu
    noi0 = next(iter(noi.values()))[0]
    dr0 = next(iter(dr.values()))[0]
    steps2 = steps + 1.0
    done2 = torch.where(torch.fmod(steps2, 3.0) < 0.5, 1.0, 0.0)
    trunc = done2 * 0.5

    def mix(base, i, scale):
        return base * 0.9 + 0.03 * act[i % nu] + scale * noi0 + 0.001 * dr0

    q_out = [torch.where(done2 > 0.5, first_q[i], mix(q[i], i, 0.01)) for i in range(s.nq)]
    v_out = [torch.where(done2 > 0.5, first_v[i], mix(v[i], i, 0.02)) for i in range(s.nv)]
    env_out = {}
    for name, (_, n) in es.env_rows.items():
        rows = env[name]
        if name == "obs_history":
            env_out[name] = [torch.where(done2 > 0.5, first_obs[i], mix(rows[i], i, 0.005))
                             for i in range(n)]
        else:
            env_out[name] = [mix(rows[i], i, 0.002) for i in range(n)]
    aux = {
        "reward": [0.1 * act[0] + 0.01 * noi0],
        "done": [done2],
        "truncation": [trunc],
        "rewards": [q[0] * 0.001 * (i + 1) for i in range(18)],
        "total_dist": [q[1] * 0.5],
    }
    return q_out, v_out, env_out, steps2, done2, aux


def _eps_from_key(key, T, B):
    """The sampling eps of JAX's key chain (``rollout.py:495-504``)."""
    def key_step(k, _):
        cur, nxt = jax.random.split(k)
        return nxt, cur

    _, used = jax.lax.scan(key_step, key, (), length=T)
    return np.array(jax.vmap(lambda k: jax.random.normal(k, (B, ACT)))(used))


@pytest.mark.parametrize("gait", [False, True], ids=["gait-off", "gait-on"])
def test_plumbing_matches_pallas_interpret(monkeypatch, gait):
    """JAX's real ``build_unroll_kernel`` (interpret mode, stubbed emission)
    and the port's ``unroll_rows`` (the same stub in torch) on the same
    state and draws: T=3 with periodic dones, so the carry, the done
    restore and the phase restart all show."""
    T = 3
    monkeypatch.setattr(jsoa_env, "_emit_wrapped_step", jtest._stub_emission)
    monkeypatch.setattr(soa_env, "_emit_wrapped_step", _torch_stub_emission)
    monkeypatch.setenv("PUPPAX_SOA_ENV", "force")
    monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")
    jenv, jwrapped, _, params = jtest._make(gait=gait)
    jstate = jtest._reset(jwrapped)
    # the stub ends an episode every third step: stagger the envs' counts
    info = dict(jstate.info, steps=jnp.asarray(np.arange(H.B) % 3, jnp.float32))
    if gait:  # start the clocks apart, some just short of 2 pi
        info["gait_phase"] = jnp.asarray(np.linspace(0.5, 6.27, H.B), jnp.float32)
    jstate = jstate.replace(info=info)
    key = jax.random.PRNGKey(5)
    jlane = jrollout.FastLane(jwrapped, mode="interpret")
    assert jlane.use_fused(T)
    jfinal, jdata = _np(jlane.unroll(jstate, (None, params), key, T, jax.nn.elu))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, : H.B]

    tenv = PupperV3Env(device="cpu", gait_phase_observation=gait, **H.env_kwargs(1))
    twrapped = wrap_for_training(tenv, jtest.EPISODE_LENGTH)
    policy = tnets.make_ppo_networks(tenv.observation_size, ACT, (32, 32), (32, 32),
                                     device="cpu").policy_network
    policy.load_state_dict(tnets.params_from_jax(_np(params)))
    tlane = FastLane(twrapped)
    assert tlane.use_fused(T)
    called = []
    rows = fused_unroll.unroll_rows
    monkeypatch.setattr(fused_unroll, "unroll_rows",
                        lambda *a: called.append(1) or rows(*a))
    tfinal, tdata = tlane.unroll_from_draws(
        state_from_jax(_np(jstate)), (None, policy), torch.from_numpy(np.array(noise)),
        torch.from_numpy(_eps_from_key(key, T, H.B)), torch.from_numpy(np.array(last_kick)))
    assert called == [1]

    atol = 1e-5
    for name in ("observation", "action", "reward", "discount", "next_observation",
                 "truncation"):
        np.testing.assert_allclose(getattr(tdata, name).numpy(), getattr(jdata, name),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tdata.policy_extras["raw_action"].numpy(),
                               jdata.policy_extras["raw_action"], atol=atol)
    np.testing.assert_allclose(tdata.policy_extras["log_prob"].numpy(),
                               jdata.policy_extras["log_prob"], atol=2e-4)
    assert all((jdata.discount[t] == 0).any() and (jdata.discount[t] == 1).any()
               for t in range(T))
    np.testing.assert_allclose(tfinal.obs.numpy(), jfinal.obs, atol=atol)
    np.testing.assert_allclose(tfinal.qpos.numpy(), jfinal.pipeline_state.qpos, atol=atol)
    np.testing.assert_allclose(tfinal.reward.numpy(), jfinal.reward, atol=atol)
    np.testing.assert_array_equal(tfinal.done.numpy(), jfinal.done)
    for name in ("steps", "truncation"):
        np.testing.assert_allclose(tfinal.info[name].numpy(), jfinal.info[name], atol=atol)
    if gait:
        np.testing.assert_allclose(tfinal.info["gait_phase"].numpy(), jfinal.info["gait_phase"],
                                   atol=1e-6)
        assert (jfinal.info["gait_phase"] == 0).any() and (jfinal.info["gait_phase"] > 0).any()


@pytest.fixture(scope="module")
def lanes():
    """The JAX xla lane and the port's fused lane on ``test_torch_rollout``'s
    set-up and draws (DR, env 1 enters done, envs 2-3 one step before the
    episode limit), and the port's K3 lane on the same draws."""
    T = 2
    jenv = H.jax_env()
    jwrapped = jwrappers.wrap_for_training(
        jenv, H.EPISODE_LENGTH, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B),
    )
    jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), H.B))
    steps = np.zeros(H.B, np.float32)
    steps[2:4] = H.EPISODE_LENGTH - 1
    done = np.zeros(H.B, np.float32)
    done[1] = 1.0
    jstate = jstate.replace(done=jnp.asarray(done),
                            info=dict(jstate.info, steps=jnp.asarray(steps)))
    params, policy = _policy("elu")
    norm = jstats.init_state(OBS).replace(mean=jnp.linspace(-0.1, 0.1, OBS),
                                          std=jnp.linspace(0.9, 1.1, OBS))
    key = jax.random.PRNGKey(11)
    jlane = jrollout.FastLane(jwrapped, mode="xla")
    jfinal, jdata = _np(jlane.unroll(jstate, (norm, params), key, T, jax.nn.elu))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, : H.B]

    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(
        H.torch_env(), H.EPISODE_LENGTH,
        randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )
    tnorm = tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std))
    tlane = FastLane(twrapped)
    draws = (torch.from_numpy(np.array(noise)), torch.from_numpy(_eps_from_key(key, T, H.B)),
             torch.from_numpy(np.array(last_kick)))
    tstate = state_from_jax(_np(jstate))
    with pytest.MonkeyPatch.context() as mp:
        k3 = tlane.unroll_from_draws(tstate, (tnorm, policy), *draws)
        mp.setenv("PUPPAX_FUSED_UNROLL", "on")
        k4 = tlane.unroll_from_draws(tstate, (tnorm, policy), *draws)
    return (jfinal, jdata), k4, k3


def test_fused_lane_matches_jax(lanes):
    (jfinal, jdata), (tfinal, tdata), _ = lanes
    close = np.testing.assert_allclose
    for name in ("observation", "next_observation", "action"):
        close(getattr(tdata, name).numpy(), getattr(jdata, name), atol=2e-4, err_msg=name)
    close(tdata.policy_extras["raw_action"].numpy(), jdata.policy_extras["raw_action"],
          atol=2e-4)
    close(tdata.policy_extras["log_prob"].numpy(), jdata.policy_extras["log_prob"], atol=1e-2)
    close(tdata.reward.numpy(), jdata.reward, atol=1e-3)
    np.testing.assert_array_equal(tdata.discount.numpy(), jdata.discount)
    np.testing.assert_array_equal(tdata.truncation.numpy(), jdata.truncation)
    assert (jdata.truncation[0, 2:4] == 1).all()
    close(tfinal.qpos.numpy(), jfinal.pipeline_state.qpos, atol=2e-4)
    close(tfinal.obs.numpy(), jfinal.obs, atol=2e-4)
    for name in ("steps", "step", "kick"):
        np.testing.assert_array_equal(tfinal.info[name].numpy(), jfinal.info[name])
    for name in ("command", "feet_air_time", "last_act", "last_vel"):
        close(tfinal.info[name].numpy(), jfinal.info[name], atol=2e-4, err_msg=name)


def test_fused_lane_matches_k3_lane(lanes):
    """The same draws through K3's lane and K4's: the folded normalizer and
    the in-order dot products are the only differences (float32 rounding)."""
    _, (tfinal, tdata), (kfinal, kdata) = lanes
    close = lambda a, b, what: torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=what)  # noqa: E731
    for name in ("observation", "next_observation", "action", "reward"):
        close(getattr(tdata, name), getattr(kdata, name), name)
    close(tdata.policy_extras["raw_action"], kdata.policy_extras["raw_action"], "raw_action")
    close(tdata.policy_extras["log_prob"], kdata.policy_extras["log_prob"], "log_prob")
    assert torch.equal(tdata.discount, kdata.discount)
    assert torch.equal(tdata.truncation, kdata.truncation)
    for name in ("qpos", "qvel", "obs"):
        close(getattr(tfinal, name), getattr(kfinal, name), name)
    for name in ("steps", "step", "last_contact"):
        assert torch.equal(tfinal.info[name], kfinal.info[name]), name


@pytest.mark.parametrize("activation", ["elu", "softmax"])
def test_policy_rows_match_the_batch_major_policy(activation):
    """Both fast-lane policies, K3's ``policy_rows`` (feature-major matmuls)
    and K4's folded MLP, sample what the learner's batch-major network
    gives for the same eps: a softmax runs over each env's features."""
    env = H.torch_env()
    lane = FastLane(wrap_for_training(env, H.EPISODE_LENGTH))
    _, policy = _policy(activation)
    nets = tnets.PPONetworks(policy, policy, lane._dist)
    norm = tstats.from_jax(np.linspace(-0.1, 0.1, OBS), np.linspace(0.9, 1.1, OBS))
    rng = np.random.RandomState(4)
    obs = torch.from_numpy(rng.normal(0, 1, (H.B, OBS)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(0, 1, (H.B, ACT)).astype(np.float32))
    want, extras = tnets.make_inference_fn(nets)((norm, policy))(obs, eps=eps)
    with torch.no_grad():
        act, raw, logp = lane.policy_rows(norm, policy)(obs.t(), eps.t())
    torch.testing.assert_close(act.t(), want, atol=1e-6, rtol=0)
    torch.testing.assert_close(logp, extras["log_prob"], atol=1e-5, rtol=0)
    h = fused_unroll.mlp_rows(fused_unroll.fold_normalizer(norm, policy), activation, obs.t())
    k4_act, _, k4_logp = fused_unroll.policy_math(h[:ACT], h[ACT:], eps.t())
    torch.testing.assert_close(torch.stack(k4_act).t(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(k4_logp, extras["log_prob"], atol=2e-4, rtol=0)


def test_use_fused_reads_the_setting_at_each_call(monkeypatch):
    tlane = FastLane(wrap_for_training(H.torch_env(), H.EPISODE_LENGTH))
    monkeypatch.delenv("PUPPAX_FUSED_UNROLL", raising=False)
    assert not tlane.use_fused(20)
    for mode in ("on", "force", "auto_on"):
        monkeypatch.setenv("PUPPAX_FUSED_UNROLL", mode)
        assert tlane.use_fused(20) and not tlane.use_fused(0)
    monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "off")
    assert not tlane.use_fused(20)


def test_unroll_wrapper_on_cpu_runs_plain_and_checks():
    """``unroll`` on CPU tensors is the plain version and counts no launch;
    it refuses malformed blocks, policies and activations."""
    env = H.torch_env()
    s, es = env._s, env._es
    wrapped = wrap_for_training(env, H.EPISODE_LENGTH)
    g = torch.Generator().manual_seed(2)
    lane = FastLane(wrapped)
    state = wrapped.reset(H.env_keys(H.B, seed=2))
    carry = lane.carry_from_state(state)
    _, policy = _policy("tanh")
    layers = fused_unroll.fold_normalizer(None, policy)
    _, noise, _ = lane.draw_noise_block(state.info["rng"], 1)
    eps = torch.randn((1, ACT, H.B), generator=g)
    args = [carry[k] for k in ("q", "v", "env", "wrap")] + [None, carry["first"], carry["dr"],
                                                             noise, eps]
    before = fused_unroll.unroll.launches
    got = fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "tanh", layers, *args)
    want = fused_unroll.unroll_rows(s, es, 1, H.EPISODE_LENGTH, "tanh", layers, *args)
    for g_, w_ in zip(got, want):
        assert (g_ is None and w_ is None) or torch.equal(g_, w_)
    assert fused_unroll.unroll.launches == before
    assert [x.shape for x in got[5:]] == [(1, es.hist, H.B), (1, ACT, H.B), (1, ACT, H.B),
                                          (1, 1, H.B), (1, 22, H.B)]
    with pytest.raises(ValueError, match="activation"):
        fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "gelu", layers, *args)
    with pytest.raises(ValueError, match="logits"):
        fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "tanh", layers[:-1], *args)
    wide = [(torch.zeros(600, es.hist), torch.zeros(600)), (torch.zeros(24, 600), torch.zeros(24))]
    with pytest.raises(ValueError, match="wide"):
        fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "tanh", wide, *args)
    bad = list(args)
    bad[7] = noise.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="noise"):
        fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "tanh", layers, *bad)
    bad = list(args)
    bad[8] = eps.double()
    with pytest.raises(ValueError, match="eps"):
        fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "tanh", layers, *bad)
    bad = list(args)
    bad[3] = carry["wrap"][:1].contiguous()
    with pytest.raises(ValueError):
        fused_unroll.unroll(s, es, 1, H.EPISODE_LENGTH, "tanh", layers, *bad)


def test_ppo_train_on_the_fused_lane(tmp_path, capsys, monkeypatch):
    """``ppo.train`` with ``PUPPAX_FUSED_UNROLL=on``: the lane line reads
    ``fused-unroll=ON``, every unroll goes through ``fused_unroll.unroll``
    (its plain version here) and none through K3's wrapper, and it trains."""
    monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")
    calls = []
    unroll = fused_unroll.unroll
    monkeypatch.setattr(fused_unroll, "unroll", lambda *a: calls.append(a[6].shape[1])
                        or unroll(*a))
    monkeypatch.setattr(soa_env, "wrapped_step", lambda *a: pytest.fail("K3 lane taken"))
    env = PupperV3Env(device="cpu", **H.env_kwargs(1))

    def factory(obs, act, device=None, key=None):
        return tnets.make_ppo_networks(obs, act, (32, 32), (32, 32), device=device, key=key)

    _, (norm, params), metrics = ppo.train(
        env, num_timesteps=8, episode_length=8, num_envs=4, num_eval_envs=2, unroll_length=2,
        batch_size=2, num_minibatches=2, num_updates_per_batch=1, num_evals=2,
        network_factory=factory, device="cpu", checkpoint_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "[puppax.ppo] rollout fast lane: ON (ok; devices=1, fused-unroll=ON)" in out
    assert calls == [4]  # one unroll of the 4 training envs
    assert float(norm.count) == 2 * 4
    assert np.isfinite(metrics["training/total_loss"])
    assert 0 < metrics["eval/avg_episode_length"] <= 8
