"""The learner's pieces against puppax and optax, on the same inputs.

Networks are made by flax and carried across with ``params_from_jax``;
batches, gradients and normal draws are made with numpy (or read from the
JAX key the reference consumes) and handed to both. Everything runs in
float32. Tolerances: 1e-6 absolute where both sides run the same ops in the
same order (GAE, the normalizer, the schedules, the distribution);
``rtol=1e-4, atol=1e-6`` for the loss, its gradients and the optimizer,
whose sums and matrix products reduce in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from puppax.configs import experiment as jexp
from puppax.train import networks as jnets
from puppax.train import ppo as jppo
from puppax.train import running_statistics as jstats
from puppax_torch import random
from puppax_torch.configs import experiment as texp
from puppax_torch.train import acting, checkpoint, ppo
from puppax_torch.train import networks as tnets
from puppax_torch.train import running_statistics as tstats
from puppax_torch.train.acting import Transition

torch.set_num_threads(1)

OBS, ACT, T, MB = 72, 12, 4, 6
GAE = dict(lambda_=0.95, discount=0.97)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-4, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _episode_data(rng, T=T, B=MB):
    """Random (T, B) rewards/values with terminations and truncations."""
    f = np.float32
    done = rng.rand(T, B) < 0.25
    trunc = done & (rng.rand(T, B) < 0.5)
    return dict(
        reward=rng.normal(0, 1, (T, B)).astype(f),
        discount=(1.0 - done).astype(f),
        truncation=trunc.astype(f),
        values=rng.normal(0, 1, (T, B)).astype(f),
        bootstrap=rng.normal(0, 1, B).astype(f),
    )


def test_compute_gae_matches_jax():
    d = _episode_data(np.random.RandomState(0), T=7, B=5)
    term = (1.0 - d["discount"]) * (1.0 - d["truncation"])
    want = jppo.compute_gae(d["truncation"], term, d["reward"], d["values"], d["bootstrap"],
                            **GAE)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = ppo.compute_gae(t["truncation"], torch.from_numpy(term), t["reward"], t["values"],
                          t["bootstrap"], **GAE)
    for g, w, name in zip(got, want, ("vs", "advantages")):
        _close(g.numpy(), w, rtol=0, what=name)


@pytest.fixture(scope="module")
def nets():
    jn = jnets.make_ppo_networks(OBS, ACT, policy_hidden_layer_sizes=(32, 32),
                                 value_hidden_layer_sizes=(32, 32), activation=jax.nn.elu)
    jparams = {"policy": jn.policy_network.init(jax.random.PRNGKey(7)),
               "value": jn.value_network.init(jax.random.PRNGKey(8))}
    norm = jstats.init_state(OBS).replace(
        mean=jnp.linspace(-0.1, 0.1, OBS), std=jnp.linspace(0.9, 1.1, OBS))
    tn = tnets.make_ppo_networks(OBS, ACT, (32, 32), (32, 32), device="cpu")
    tn.policy_network.load_state_dict(tnets.params_from_jax(_np(jparams["policy"])))
    tn.value_network.load_state_dict(tnets.params_from_jax(_np(jparams["value"])))
    tnorm = tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std))
    return jn, jparams, norm, tn, tnorm


def _minibatch(rng):
    f = np.float32
    d = _episode_data(rng)
    obs = rng.normal(0, 1, (T + 1, MB, OBS)).astype(f)
    return dict(
        observation=obs[:T], next_observation=obs[1:], reward=d["reward"],
        discount=d["discount"], truncation=d["truncation"],
        raw_action=rng.normal(0, 1, (T, MB, ACT)).astype(f),
        log_prob=rng.normal(-10, 2, (T, MB)).astype(f),
    )


def _jax_loss(jn, params, norm, b, key, entropy_cost):
    """``puppax/train/ppo.py:306-384`` built from the JAX package's parts."""
    dist = jn.action_distribution
    logits = jn.policy_network.apply(norm, params["policy"], b["observation"])
    baseline = jn.value_network.apply(norm, params["value"], b["observation"])
    boot = jn.value_network.apply(norm, params["value"], b["next_observation"][-1])
    term = (1.0 - b["discount"]) * (1.0 - b["truncation"])
    vs, adv = jppo.compute_gae(b["truncation"], term, b["reward"], baseline, boot, **GAE)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    rho = jnp.exp(dist.log_prob(logits, b["raw_action"]) - b["log_prob"])
    policy_loss = -jnp.mean(jnp.minimum(rho * adv, jnp.clip(rho, 0.7, 1.3) * adv))
    value_loss = 0.25 * jnp.mean((vs - baseline) ** 2)
    entropy_loss = -entropy_cost * jnp.mean(dist.entropy(logits, key))
    total = policy_loss + value_loss + entropy_loss
    return total, (policy_loss, value_loss, entropy_loss)


def test_loss_and_gradients_match_jax(nets):
    jn, jparams, norm, tn, tnorm = nets
    b = _minibatch(np.random.RandomState(1))
    key = jax.random.PRNGKey(4)
    # the normal draws dist.entropy takes from its key
    eps = np.array(jax.random.normal(key, (T, MB, ACT), jnp.float32))
    (jtotal, jparts), jgrads = jax.value_and_grad(_jax_loss, argnums=1, has_aux=True)(
        jn, jparams, norm, b, key, 0.01)
    data = Transition(
        observation=torch.from_numpy(b["observation"]), action=torch.zeros(T, MB, ACT),
        reward=torch.from_numpy(b["reward"]), discount=torch.from_numpy(b["discount"]),
        next_observation=torch.from_numpy(b["next_observation"]),
        truncation=torch.from_numpy(b["truncation"]),
        policy_extras={"raw_action": torch.from_numpy(b["raw_action"]),
                       "log_prob": torch.from_numpy(b["log_prob"])},
    )
    total, metrics = ppo.compute_ppo_loss(tn, tnorm, data, torch.from_numpy(eps), 0.01)
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


def _adam_case():
    rng = np.random.RandomState(2)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 3, s).astype(np.float32) for s in shapes] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("max_grad_norm", [None, 1.5])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
def test_adam_matches_optax(max_grad_norm, schedule):
    params, grads = _adam_case()
    lr = ppo.lr_schedule_fn(1e-2, schedule, 0.1, total_updates=4)
    jlr = {"constant": 1e-2,
           "cosine": optax.cosine_decay_schedule(1e-2, decay_steps=4, alpha=0.1),
           "linear": optax.linear_schedule(1e-2, 1e-3, 4)}[schedule]
    chain = [optax.adam(learning_rate=jlr)]
    if max_grad_norm is not None:
        chain.insert(0, optax.clip_by_global_norm(max_grad_norm))
    opt = optax.chain(*chain)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    adam = ppo.Adam(tp, lr, max_grad_norm)
    for i, g in enumerate(grads):
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.from_numpy(x) for x in g])
        if i in (0, 2):  # one and three steps
            for a, b in zip(tp, jp):
                _close(a.numpy(), np.asarray(b), what=f"step {i + 1}")
    assert adam.count == 3


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_lr_schedules_match_optax(schedule):
    total = 100
    fn = ppo.lr_schedule_fn(3e-4, schedule, 0.05, total)
    ref = (optax.cosine_decay_schedule(3e-4, decay_steps=total, alpha=0.05)
           if schedule == "cosine" else optax.linear_schedule(3e-4, 3e-4 * 0.05, total))
    for count in (0, 1, 7, 50, 99, 100, 150):
        _close(fn(count), float(ref(count)), rtol=1e-6, atol=0, what=f"count {count}")
    assert ppo.lr_schedule_fn(3e-4, "constant", 0.0, total)(17) == 3e-4
    with pytest.raises(ValueError):
        ppo.lr_schedule_fn(3e-4, "step", 0.0, total)


def test_running_statistics_update_matches_jax():
    rng = np.random.RandomState(3)
    js = jstats.init_state(OBS)
    ts = tstats.init_state(OBS, device="cpu")
    for i in range(2):
        batch = rng.normal(i, 2.0, (T, 16, OBS)).astype(np.float32)
        js = jstats.update(js, jnp.asarray(batch))
        ts = tstats.update(ts, torch.from_numpy(batch))
    for name in ("count", "mean", "summed_variance", "std"):
        _close(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-5,
               what=name)


def test_eager_and_lazy_shuffle_give_the_same_minibatches():
    rng = np.random.RandomState(4)
    N, M = 12, 3
    data = Transition(
        observation=torch.from_numpy(rng.normal(size=(T, N, 5)).astype(np.float32)),
        action=torch.zeros(T, N, 2), reward=torch.arange(T * N, dtype=torch.float32).reshape(T, N),
        discount=torch.ones(T, N), next_observation=torch.zeros(T, N, 5),
        truncation=torch.zeros(T, N),
        policy_extras={"log_prob": torch.zeros(T, N), "raw_action": torch.zeros(T, N, 2)},
    )
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(0))
    eager = list(ppo.minibatches(data, perm, M, lazy_shuffle=False))
    lazy = list(ppo.minibatches(data, perm, M, lazy_shuffle=True))
    assert len(eager) == len(lazy) == M
    for m, (e, z) in enumerate(zip(eager, lazy)):
        assert torch.equal(e.observation, z.observation)
        assert torch.equal(e.reward, data.reward[:, perm[m * 4 : (m + 1) * 4]])
        assert torch.equal(e.reward, z.reward)


def test_distribution_matches_jax(nets):
    jn, *_ = nets
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 1, (MB, 2 * ACT)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    eps = np.array(jax.random.normal(key, (MB, ACT), jnp.float32))
    jd, td = jn.action_distribution, tnets.NormalTanhDistribution(ACT)
    tl = torch.from_numpy(logits)
    _close(td.sample_no_postprocessing(tl, eps=torch.from_numpy(eps)).numpy(),
           jd.sample_no_postprocessing(jnp.asarray(logits), key), rtol=0, what="sample")
    _close(td.mode(tl).numpy(), jd.mode(jnp.asarray(logits)), rtol=0, what="mode")
    _close(td.entropy(tl, eps=torch.from_numpy(eps)).numpy(),
           jd.entropy(jnp.asarray(logits), key), rtol=0, atol=1e-5, what="entropy")
    # the port's own draw from the same key: normal within a few ulp of jax's
    _close(td.entropy(tl, key=random.from_key_data(np.asarray(jax.random.key_data(key)))).numpy(),
           jd.entropy(jnp.asarray(logits), key), rtol=0, atol=1e-5, what="entropy from the key")


@pytest.mark.parametrize("deterministic", [False, True])
def test_make_inference_fn_matches_jax(nets, deterministic):
    jn, jparams, norm, tn, tnorm = nets
    obs = np.random.RandomState(6).normal(0, 1, (MB, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jpolicy = jnets.make_inference_fn(jn)((norm, jparams["policy"]), deterministic)
    tpolicy = tnets.make_inference_fn(tn)((tnorm, tn.policy_network), deterministic)
    jact, jextra = jpolicy(jnp.asarray(obs), key)
    eps = np.array(jax.random.normal(key, (MB, ACT), jnp.float32))
    tact, textra = tpolicy(torch.from_numpy(obs), eps=torch.from_numpy(eps))
    _close(tact.detach().numpy(), jact, atol=1e-6, what="action")
    assert set(textra) == set(jextra)
    for k in textra:
        _close(textra[k].detach().numpy(), jextra[k], atol=1e-4, what=k)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_value_precision_products_and_gradients(precision):
    """The TF32 value net computes what the float32 one does on the CPU
    (the flag acts only on the card), gradients included, and the policy
    keeps full float32."""
    hi = tnets.make_ppo_networks(OBS, ACT, (16,), (16, 16), device="cpu", key=random.key(3))
    lo = tnets.make_ppo_networks(OBS, ACT, (16,), (16, 16), device="cpu", key=random.key(3),
                                 value_precision=precision)
    assert lo.value_network.precision == precision
    assert lo.policy_network.precision == "highest"
    x = torch.randn(T, MB, OBS, generator=torch.Generator().manual_seed(1))
    outs = []
    for n in (hi, lo):
        v = n.value_apply(None, x)
        assert v.shape == (T, MB)
        outs.append((v, torch.autograd.grad(v.square().sum(), list(n.value_network.parameters()))))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tnets.MLP(4, (2,), device="cpu", precision="fast")


def test_episode_metrics_mask_after_first_done():
    """Per-episode sums up to and including each env's first done, averaged
    over envs; ``total_dist`` read at the end (``acting.py:134-159``)."""
    T_, B = 5, 3
    reward = torch.arange(1, T_ * B + 1, dtype=torch.float32).reshape(T_, B)
    discount = torch.ones(T_, B)
    discount[1, 0] = 0.0  # env 0 ends at step 1
    discount[3, 1] = 0.0  # env 1 ends at step 3, again at 4
    discount[4, 1] = 0.0
    term = torch.full((T_, B), 2.0)
    data = Transition(observation=None, action=None, reward=reward, discount=discount,
                      next_observation=None, truncation=None, policy_extras={},
                      metrics={"torques": term, "total_dist": torch.zeros(T_, B)})
    final = type("S", (), {"metrics": {"total_dist": torch.tensor([1.0, 2.0, 6.0])}})
    m = acting.episode_metrics(data, final)
    sums = np.array([1 + 4, 2 + 5 + 8 + 11, reward[:, 2].sum().item()])
    lengths = np.array([2, 4, 5])
    assert m["eval/episode_reward"].item() == pytest.approx(sums.mean())
    assert m["eval/episode_reward_std"].item() == pytest.approx(sums.std())
    assert m["eval/avg_episode_length"].item() == pytest.approx(lengths.mean())
    assert m["eval/episode_torques"].item() == pytest.approx(2.0 * lengths.mean())
    assert m["eval/episode_total_dist"].item() == pytest.approx(3.0)


def test_config_hash_and_overrides_match_jax():
    over = {"train.num_envs": 8, "env.kick_vel": 0.5, "train.policy_hidden_layer_sizes": [32, 32],
            "env.start_position.z_max": 0.3}
    jcfg = jexp.apply_overrides(jexp.ExperimentConfig(), over)
    tcfg = texp.apply_overrides(texp.ExperimentConfig(), over)
    assert texp.config_hash(texp.ExperimentConfig()) == jexp.config_hash(jexp.ExperimentConfig())
    assert texp.config_hash(tcfg) == jexp.config_hash(jcfg)
    assert texp.to_dict(tcfg) == jexp.to_dict(jcfg)
    assert tcfg.train.policy_hidden_layer_sizes == (32, 32)
    assert texp.from_dict(texp.to_dict(tcfg)) == tcfg
    for bad in ("train.nonexistent", "nothing.num_envs"):
        with pytest.raises(KeyError, match="unknown config key"):
            texp.apply_overrides(tcfg, {bad: 1})


def test_checkpoint_round_trip(tmp_path, nets):
    *_, tn, tnorm = nets
    opt = ppo.Adam(list(tn.policy_network.parameters()), lambda c: 1e-3)
    opt.step([torch.ones_like(p) for p in opt.params])
    ts = ppo.TrainingState(tn, opt, tnorm, env_steps=2**40 + 3)  # past int32
    assert checkpoint.latest_checkpoint_step(tmp_path) is None
    for step in (5, 40):
        path = checkpoint.save_checkpoint(step, ts.state_dict(), tmp_path)
    assert path.endswith("/40")
    assert checkpoint.latest_checkpoint_step(tmp_path) == 40
    tree = checkpoint.restore_checkpoint(tmp_path)
    assert tree["env_steps"] == 2**40 + 3 and tree["optimizer"]["count"] == 1
    tn2 = tnets.make_ppo_networks(OBS, ACT, (32, 32), (32, 32), device="cpu")
    opt2 = ppo.Adam(list(tn2.policy_network.parameters()), lambda c: 1e-3)
    ts2 = ppo.TrainingState(tn2, opt2, tstats.init_state(OBS, device="cpu"))
    ts2.load_state_dict(tree)
    assert ts2.env_steps == ts.env_steps and opt2.count == 1
    for a, b in zip(tn.value_network.parameters(), tn2.value_network.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt.mu, opt2.mu):
        assert torch.equal(a, b)
    assert torch.equal(ts2.normalizer_params.std, tnorm.std)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(tmp_path / "none")


def test_generators_per_stream():
    """The key tree's streams (``ppo.init_keys``, which replaced one
    generator per stream): the same seed gives the same keys, another seed
    others, and no two streams share a key."""
    a, b = ppo.init_keys(0, 4, True, "cpu"), ppo.init_keys(0, 4, True, "cpu")
    c = ppo.init_keys(1, 4, True, "cpu")
    assert set(a) == {"key", "network", "env", "eval", "dr"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["key"], c["key"])
    assert a["env"].shape == a["dr"].shape == (4, 2)
    flat = torch.cat([a[k].reshape(-1, 2) for k in a])
    assert len({tuple(r) for r in flat.tolist()}) == len(flat)
    assert "dr" not in ppo.init_keys(0, 4, False, "cpu")


@pytest.mark.parametrize("option", [
    {"privileged_critic": True}, {"curriculum_steps": 10}, {"devices": ["cpu", "cpu"]},
])
def test_unported_train_options_raise(option):
    """One process given several devices raises a ``ValueError`` that
    names the launcher (one process per GPU; the runs across ranks:
    ``test_torch_parallel.py``); the privileged critic and the curriculum
    raise JAX's ``ValueError`` on an env that publishes no privileged obs
    or no difficulty (their runs: ``test_torch_extras.py``)."""
    if "devices" in option:
        env = type("E", (), {"device": torch.device("cpu")})
        with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node"):
            ppo.train(env, 8, 8, device="cpu", **option)
        return
    from puppax_torch.env.pupper import PupperV3Env

    match = "privileged_obs" if "privileged_critic" in option else "disturbance_curriculum"
    with pytest.raises(ValueError, match=match):
        ppo.train(PupperV3Env(device="cpu"), 8, 8, num_envs=4, batch_size=4, num_minibatches=1,
                  device="cpu", **option)
