"""run12's training extras against puppax: the disturbance curriculum, the
privileged critic and ``action_repeat``, and run12's configuration through
the training CLI.

* ``ppo.curriculum_difficulty`` bit for bit with the JAX learner's float32
  ``clip((hi * 2**30 + lo) / curriculum_steps, 0, 1)`` (``ppo.py:506-520``)
  at small and large step counts;
* the difficulty's scaling of the five disturbance draws: an env with the
  curriculum at difficulty d equals, bit for bit, the plain env fed the
  draws times d (at d = 1, the plain env's draws), and the fast lane's
  ``scale_noise_block`` equals the scaled draws' noise block;
* the privileged critic: the value net widened by 34 inputs, its loss and
  gradients against a JAX loss built from ``puppax.train`` (``ppo.py:
  306-384`` with the critic's inputs) on the same flax params and batch
  (rtol 1e-4 / atol 1e-6, ``test_torch_learner.py``'s), and the critic
  normalizer's update on the concatenated batch against
  ``running_statistics.update`` (rtol 1e-5);
* ``action_repeat = 2`` on the standard lane against puppax's
  ``EpisodeWrapper`` (two env steps on the same draws, their rewards
  summed, ``steps`` + 2, truncation at the episode length; obs and reward
  2e-4, done and the counters exact), JAX's ``support_reason`` string, and
  a ``ppo.train`` run on it;
* ``python -m puppax_torch.scripts.train --config
  dev/run_configs/run12_2b_cse.json`` cut to a tiny size (4 envs, 1
  substep, episodes of 4 steps, so every env ends one inside training, 3
  training steps, curriculum over 16 env steps) on the K3, the
  physics-only and the fused lane (the plain versions): its config hash
  equals ``scripts/train.py``'s, the lane line, the difficulty at 0, 0.5
  and 1, finite losses, the critic normalizer's count in the saved state,
  and a resume that restores it.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.configs import experiment as jexp
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import domain_randomization as jdr
from puppax.env import wrappers as jwrappers
from puppax.train import networks as jnets
from puppax.train import ppo as jppo
from puppax.train import running_statistics as jstats
from puppax_torch.env import rollout, soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import DISTURBANCE_KEYS, PupperV3Env, scale_disturbances
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.scripts import train as cli
from puppax_torch.train import checkpoint, ppo
from puppax_torch.train import networks as tnets
from puppax_torch.train import running_statistics as tstats
from puppax_torch.train.acting import Transition

torch.set_num_threads(1)

RUN12 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "dev", "run_configs", "run12_2b_cse.json")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-4, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# ---- the disturbance curriculum ---------------------------------------------


@pytest.mark.parametrize("curriculum_steps", [500_000_000, 16, 3_000_000_017])
def test_curriculum_difficulty_bit_for_bit_with_jax(curriculum_steps):
    counts = [0, 1, 8, 123_456_789, 499_999_999, 500_000_000, 2_000_000_007,
              2**31 + 5, 3_000_000_017, 5_000_000_000]

    @jax.jit
    def jax_d(hi, lo):  # ppo.py:512-517, in-graph
        steps_f = hi.astype(jnp.float32) * jppo._STEP_BASE + lo.astype(jnp.float32)
        return jnp.clip(steps_f / float(curriculum_steps), 0.0, 1.0)

    got, want = [], []
    for n in counts:
        c = jppo.StepCount.zero()
        while n - (c.to_int()) >= 2**29:
            c = c.add(2**29)
        c = c.add(n - c.to_int())
        assert c.to_int() == n
        want.append(np.asarray(jax_d(c.hi, c.lo), np.float32))
        got.append(ppo.curriculum_difficulty(n, curriculum_steps))
        assert got[-1].dtype == np.float32
    np.testing.assert_array_equal(np.array(got).view(np.int32), np.array(want).view(np.int32))
    assert got[0] == 0.0 and got[-1] == 1.0


def _blocks_and_state(env, B, seed):
    g = torch.Generator().manual_seed(seed)
    wrapped = wrap_for_training(env, 1000)
    state = wrapped.reset(H.env_keys(B, seed=seed), caches=True)
    noise = env.draw_step_noise(state.info["rng"])
    noise["kick"] = torch.rand((B, 2), generator=g) - 0.5  # every env kicked
    act = torch.rand((B, 12), generator=g) * 2 - 1
    return wrapped, state, noise, act


@pytest.mark.parametrize("d", [1.0, 0.37, 0.0])
def test_difficulty_scales_the_five_draws(d):
    kw = H.env_kwargs(1)
    curr = PupperV3Env(device="cpu", disturbance_curriculum=True, **kw)
    plain = PupperV3Env(device="cpu", **kw)
    B = 6
    wrapped, state, noise, act = _blocks_and_state(curr, B, 4)
    assert torch.equal(state.info["difficulty"], torch.ones(B))
    diff = torch.full((B,), d)
    got = wrapped.step_from_draws(state.replace(info=dict(state.info, difficulty=diff)), act,
                                  noise)
    pw = wrap_for_training(plain, 1000)
    pstate = state.replace(info={k: v for k, v in state.info.items() if k != "difficulty"})
    scaled = noise if d == 1.0 else {k: v * d if k in DISTURBANCE_KEYS else v
                                     for k, v in noise.items()}
    want = pw.step_from_draws(pstate, act, scaled)
    for name in ("obs", "reward", "done", "qpos", "qvel"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.info["kick"], scaled["kick"])
    assert torch.equal(got.info["difficulty"], diff)
    # the fast lane scales the same rows of its noise block
    es = curr._es
    block = soa_env.noise_block(es, noise)[None]
    assert torch.equal(rollout.scale_noise_block(es, block, diff)[0],
                       soa_env.noise_block(es, scale_disturbances(noise, diff[:, None])))


# ---- the privileged critic ----------------------------------------------------

OBS, PRIV, ACT, T, MB = 146, 34, 12, 4, 6


@pytest.fixture(scope="module")
def critic():
    jn = jnets.make_ppo_networks(OBS, ACT, policy_hidden_layer_sizes=(32, 32),
                                 value_hidden_layer_sizes=(32, 32), activation=jax.nn.elu,
                                 privileged_size=PRIV)
    jparams = {"policy": jn.policy_network.init(jax.random.PRNGKey(7)),
               "value": jn.value_network.init(jax.random.PRNGKey(8))}
    norm = jstats.init_state(OBS).replace(mean=jnp.linspace(-0.1, 0.1, OBS),
                                          std=jnp.linspace(0.9, 1.1, OBS))
    cnorm = jstats.init_state(OBS + PRIV).replace(mean=jnp.linspace(-0.3, 0.2, OBS + PRIV),
                                                  std=jnp.linspace(0.5, 2.0, OBS + PRIV))
    tn = tnets.make_ppo_networks(OBS, ACT, (32, 32), (32, 32), device="cpu",
                                 privileged_size=PRIV)
    assert tn.value_network.hidden_0.weight.shape == (32, OBS + PRIV)
    assert tn.policy_network.hidden_0.weight.shape == (32, OBS)
    tn.policy_network.load_state_dict(tnets.params_from_jax(_np(jparams["policy"])))
    tn.value_network.load_state_dict(tnets.params_from_jax(_np(jparams["value"])))
    tnorm = tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std))
    tcnorm = tstats.from_jax(np.asarray(cnorm.mean), np.asarray(cnorm.std))
    return jn, jparams, norm, cnorm, tn, tnorm, tcnorm


def _batch(rng):
    f = np.float32
    done = rng.rand(T, MB) < 0.25
    obs = rng.normal(0, 1, (T + 1, MB, OBS)).astype(f)
    priv = rng.normal(0, 1, (T + 1, MB, PRIV)).astype(f)
    return dict(
        observation=obs[:T], next_observation=obs[1:], privileged_obs=priv[:T],
        next_privileged_obs=priv[1:], reward=rng.normal(0, 1, (T, MB)).astype(f),
        discount=(1.0 - done).astype(f),
        truncation=(done & (rng.rand(T, MB) < 0.5)).astype(f),
        raw_action=rng.normal(0, 1, (T, MB, ACT)).astype(f),
        log_prob=rng.normal(-10, 2, (T, MB)).astype(f),
    )


def _jax_critic_loss(jn, params, norm, cnorm, b, key, entropy_cost):
    """``puppax/train/ppo.py:306-384`` with ``privileged_critic=True``,
    built from the JAX package's parts."""
    dist = jn.action_distribution
    logits = jn.policy_network.apply(norm, params["policy"], b["observation"])
    critic_obs = jnp.concatenate([b["observation"], b["privileged_obs"]], axis=-1)
    critic_boot = jnp.concatenate([b["next_observation"][-1], b["next_privileged_obs"][-1]],
                                  axis=-1)
    baseline = jn.value_network.apply(cnorm, params["value"], critic_obs)
    boot = jn.value_network.apply(cnorm, params["value"], critic_boot)
    term = (1.0 - b["discount"]) * (1.0 - b["truncation"])
    vs, adv = jppo.compute_gae(b["truncation"], term, b["reward"], baseline, boot,
                               lambda_=0.95, discount=0.97)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    rho = jnp.exp(dist.log_prob(logits, b["raw_action"]) - b["log_prob"])
    policy_loss = -jnp.mean(jnp.minimum(rho * adv, jnp.clip(rho, 0.7, 1.3) * adv))
    value_loss = 0.25 * jnp.mean((vs - baseline) ** 2)
    entropy_loss = -entropy_cost * jnp.mean(dist.entropy(logits, key))
    total = policy_loss + value_loss + entropy_loss
    return total, (policy_loss, value_loss, entropy_loss)


def test_privileged_critic_loss_and_gradients_match_jax(critic):
    jn, jparams, norm, cnorm, tn, tnorm, tcnorm = critic
    b = _batch(np.random.RandomState(1))
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(key, (T, MB, ACT), jnp.float32))
    (jtotal, jparts), jgrads = jax.value_and_grad(_jax_critic_loss, argnums=1, has_aux=True)(
        jn, jparams, norm, cnorm, b, key, 0.01)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    data = Transition(
        observation=t["observation"], action=torch.zeros(T, MB, ACT), reward=t["reward"],
        discount=t["discount"], next_observation=t["next_observation"],
        truncation=t["truncation"],
        policy_extras={"raw_action": t["raw_action"], "log_prob": t["log_prob"]},
        extras={"privileged_obs": t["privileged_obs"],
                "next_privileged_obs": t["next_privileged_obs"]},
    )
    total, metrics = ppo.compute_ppo_loss(tn, tnorm, data, torch.from_numpy(eps), 0.01,
                                          privileged_critic=True, critic_normalizer=tcnorm)
    _close(total.item(), jtotal, what="total loss")
    for name, w in zip(("policy_loss", "value_loss", "entropy_loss"), jparts):
        _close(metrics[name].item(), w, what=name)
    for net in ("policy", "value"):
        module = getattr(tn, f"{net}_network")
        grads = torch.autograd.grad(total, list(module.parameters()), retain_graph=True)
        want = tnets.params_from_jax(_np(jgrads[net]))
        for (name, _), g in zip(module.named_parameters(), grads):
            scale = max(1.0, float(np.abs(want[name].numpy()).max()))
            _close(g.numpy() / scale, want[name].numpy() / scale, what=f"{net} {name}")
    # the critic normalizer's update on the concatenated batch
    cat = np.concatenate([b["observation"], b["privileged_obs"]], -1)
    js = jstats.update(jstats.init_state(OBS + PRIV), jnp.asarray(cat))
    ts = tstats.update(tstats.init_state(OBS + PRIV, device="cpu"),
                       ppo.critic_inputs(data)[0])
    for name in ("count", "mean", "summed_variance", "std"):
        _close(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-5, what=name)


# ---- action_repeat --------------------------------------------------------------


def test_action_repeat_matches_jax_episode_wrapper():
    L, B = 5, H.B
    kw = H.env_kwargs(1)
    jenv = JaxEnv(path=None, reward_config=get_config(), **kw)
    jwrapped = jwrappers.wrap_for_training(
        jenv, L, action_repeat=2, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), B))
    jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), B))
    steps = np.zeros(B, np.float32)
    steps[2:4] = L - 2  # + 2 reaches the limit
    jstate = jstate.replace(info=dict(jstate.info, steps=jnp.asarray(steps)))
    start = _np(jstate)
    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(PupperV3Env(device="cpu", **kw), L, action_repeat=2,
                                 randomization_fn=lambda m, keys: m.with_leaves(**leaves),
                                 randomization_keys=H.env_keys(B))
    assert rollout.support_reason(twrapped) == (False, "action_repeat=2 (kernel fuses 1)")
    from puppax.env import rollout as jrollout

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PUPPAX_SOA_ENV", "force")  # past JAX's backend check
        assert jrollout.support_reason(jwrapped) == rollout.support_reason(twrapped)
    draw = jax.jit(jax.vmap(jenv._draw_step_noise))
    rng, noises = jstate.info["rng"], []
    for _ in range(2):  # the inner steps' draws, on the env's key chain
        n = draw(rng)
        rng = n["rng"]
        noises.append({k: torch.from_numpy(np.array(v)) for k, v in n.items()
                       if k in jenv._CORE_NOISE_KEYS})
    act = np.random.RandomState(2).uniform(-1, 1, (B, 12)).astype(np.float32)
    j = _np(jax.jit(jwrapped.step)(jstate, jnp.asarray(act)))
    state = twrapped.step_from_draws(state_from_jax(start), torch.from_numpy(act), noises)
    np.testing.assert_allclose(state.obs.numpy(), j.obs, rtol=0, atol=2e-4)
    np.testing.assert_allclose(state.reward.numpy(), j.reward, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(state.done.numpy(), j.done)
    np.testing.assert_array_equal(state.info["steps"].numpy(), j.info["steps"])
    np.testing.assert_array_equal(state.info["truncation"].numpy(), j.info["truncation"])
    assert (j.info["truncation"][2:4] == 1).all() and (j.info["steps"][4:] == 2).all()
    # the reward is the two env steps' sum
    one = wrap_for_training(twrapped.env, L, randomization_fn=lambda m, keys: m.with_leaves(
        **leaves), randomization_keys=H.env_keys(B))
    s1 = one.step_from_draws(state_from_jax(start), torch.from_numpy(act), noises[0])
    s2 = twrapped.env.step_from_draws(s1, torch.from_numpy(act), noises[1],
                                      twrapped.dr_rows(B), twrapped.model)
    live = ~(s1.done > 0.5)
    assert torch.equal(state.reward[live], (s1.reward + s2.reward)[live])
    with pytest.raises(ValueError, match="action_repeat=2"):
        twrapped.step_from_draws(state_from_jax(start), torch.from_numpy(act), noises[:1])


def test_ppo_train_with_action_repeat(capsys):
    env = PupperV3Env(device="cpu", **H.env_kwargs(1))
    nets = lambda o, a, **kw: tnets.make_ppo_networks(o, a, (16,), (16,), **kw)  # noqa: E731
    progress = []
    _, params, metrics = ppo.train(
        env, num_timesteps=16, episode_length=4, num_envs=4, num_eval_envs=2, action_repeat=2,
        unroll_length=2, batch_size=2, num_minibatches=2, num_updates_per_batch=1,
        num_evals=2, network_factory=nets, device="cpu",
        progress_fn=lambda step, m: progress.append((step, m)))
    out = capsys.readouterr().out
    assert "rollout fast lane: OFF (action_repeat=2 (kernel fuses 1); devices=1)" in out
    assert [s for s, _ in progress] == [0, 16]  # 2 x 2 x 2 x 2 env steps per training step
    assert all(math.isfinite(v) for k, v in metrics.items() if k.endswith("_loss"))
    assert 0 < metrics["eval/avg_episode_length"] <= 2  # 4 // 2 steps per eval episode


# ---- run12 through the training CLI -------------------------------------------

TINY = {
    "train.num_timesteps": 24, "train.num_envs": 4, "train.episode_length": 4,
    "train.unroll_length": 2, "train.batch_size": 2, "train.num_minibatches": 2,
    "train.num_updates_per_batch": 1, "train.num_evals": 2, "train.num_eval_envs": 2,
    "train.curriculum_steps": 16, "env.environment_timestep": 0.004,
    "train.policy_hidden_layer_sizes": [32, 32], "train.value_hidden_layer_sizes": [32, 32],
}


@pytest.mark.parametrize("lane", ["k3", "physics-only", "fused"])
def test_run12_through_the_cli(tmp_path, capsys, monkeypatch, lane):
    if lane == "physics-only":
        monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
    if lane == "fused":
        monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")
    seen = []
    for owner, name in ((rollout.FastLane, "unroll"), (ppo.acting, "generate_unroll")):
        fn = getattr(owner, name)

        def spy(*args, _fn=fn, **kw):
            state = args[1]  # (lane, state, ...) and (env, state, ...)
            if "difficulty" in state.info and state.info["difficulty"].shape[0] == 4:
                seen.append(float(state.info["difficulty"][0]))
            return _fn(*args, **kw)

        monkeypatch.setattr(owner, name, spy)
    over = dict(TINY, **{"train.checkpoint_path": str(tmp_path / "ckpt"),
                         "train.metrics_jsonl": str(tmp_path / "metrics.jsonl")})
    argv = ["--config", RUN12, "--device", "cpu"]
    for k, v in over.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    metrics = cli.main(argv)
    out = capsys.readouterr().out
    with open(RUN12) as f:
        want_hash = jexp.config_hash(jexp.apply_overrides(jexp.from_dict(json.load(f)), over))
    assert f"config hash: {want_hash}" in out
    line = {"k3": "ON (ok; devices=1, fused-unroll=OFF)",
            "physics-only": "OFF (PUPPAX_SOA_ENV=off; devices=1)",
            "fused": "ON (ok; devices=1, fused-unroll=ON)"}[lane]
    assert f"rollout fast lane: {line}" in out
    assert seen == [0.0, 0.5, 1.0]  # the difficulty before each training step's rollout
    for k in ("training/total_loss", "training/value_loss", "eval/episode_reward"):
        assert math.isfinite(metrics[k]), k
    tree = checkpoint.restore_checkpoint(tmp_path / "ckpt" / "state")
    assert tree["env_steps"] == 24
    cn = tree["critic_normalizer"]
    assert cn["mean"].shape == (146 + 34,) and float(cn["count"]) == 24.0
    assert tree["params"]["value"]["hidden_0.weight"].shape == (32, 146 + 34)
    assert tree["params"]["normalizer"]["mean"].shape == (146,)
    if lane == "k3":  # a resume restores the critic normalizer
        nets = tnets.make_ppo_networks(146, 12, (32, 32), (32, 32), device="cpu",
                                       privileged_size=34)
        ts = ppo.TrainingState(nets, ppo.Adam(list(nets.policy_network.parameters())
                                              + list(nets.value_network.parameters()),
                                              lambda c: 0.0),
                               tstats.init_state(146, "cpu"),
                               critic_normalizer_params=tstats.init_state(180, "cpu"))
        ts.load_state_dict(tree)
        assert torch.equal(ts.critic_normalizer_params.mean, cn["mean"])
        assert ts.state_dict()["critic_normalizer"]["count"] == cn["count"]
