"""Resuming a JAX train state in the port.

A tiny ``puppax`` train state is written as ``puppax/train/ppo.py:773-781``
writes it (orbax, ``<ckpt>/state/<step>/``): optax's adam after three
updates on numpy-seeded gradients, alone with a constant lr or after
``clip_by_global_norm`` with the cosine schedule, numpy-seeded params and
normalizers (and a privileged critic's), and a two-limb env-step count
past 2**30. ``convert_orbax_checkpoint.py`` converts it to
``<out>/state/<step>/``; every leaf of the result is the orbax leaf
(kernels transposed, Adam's moments in ``ppo.Adam.params``' order).

``ppo.train(checkpoint_dir=<out>, resume=True)`` then resumes: its first
normalizer update starts from JAX's normalizers and its first ``Adam.step``
from JAX's params, count and moments, all bit for bit; that update, on the
gradients the port computed, is held against optax's ``update`` from the
same state on the same gradients at ``tests/test_torch_learner.py``'s
tolerances (rtol 1e-4 / atol 1e-6). A run whose target the restored count
has passed trains no step (the count is ``hi * 2**30 + lo``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_helpers as H
from puppax.train import checkpoint as jcheckpoint
from puppax.train import networks as jnets
from puppax.train import ppo as jppo
from puppax.train.running_statistics import RunningStatisticsState as JNorm
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.train import checkpoint, ppo, running_statistics
from puppax_torch.train import networks as tnets

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT, POLICY, VALUE = 12, (32, 16), (32,)
HI, LO = 1, 16
ENV_STEPS = HI * 2**30 + LO
TRAIN = dict(episode_length=8, num_envs=4, num_eval_envs=2, unroll_length=2, batch_size=4,
             num_minibatches=1, num_updates_per_batch=1, learning_rate=1e-3,
             lr_final_fraction=0.1, seed=2, device="cpu")
# ppo.train's num_training_steps_per_epoch x num_minibatches for a target
# one training step (8 env steps) past the restored count
TOTAL_UPDATES = -(-(ENV_STEPS + 8) // 8)


class _Stop(Exception):
    pass


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_checkpoint", os.path.join(ROOT, "convert_orbax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norm(rng, n):
    count = np.float32(96.0)
    std = rng.uniform(0.3, 2.0, n).astype(np.float32)
    return JNorm(count=jnp.float32(count), mean=jnp.asarray(rng.standard_normal(n)
                                                              .astype(np.float32)),
                 summed_variance=jnp.asarray(std**2 * count), std=jnp.asarray(std))


def _optimizer(clip):
    if clip:
        return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
            optax.cosine_decay_schedule(TRAIN["learning_rate"], decay_steps=TOTAL_UPDATES,
                                        alpha=TRAIN["lr_final_fraction"])))
    return optax.adam(TRAIN["learning_rate"])


def _jax_state(env, priv, clip):
    rng = np.random.default_rng(4 + priv)
    obs = env.observation_size
    jn = jnets.make_ppo_networks(obs, ACT, POLICY, VALUE,
                                 privileged_size=env.privileged_obs_size if priv else 0)
    params = jnets.PPONetworkParams(policy=jn.policy_network.init(jax.random.PRNGKey(1)),
                                    value=jn.value_network.init(jax.random.PRNGKey(2)))
    opt = _optimizer(clip)
    state = opt.init(params)
    for _ in range(3):  # adam after a few updates
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return jppo.TrainingState(
        optimizer_state=state, params=params, normalizer_params=_norm(rng, obs),
        env_steps=jppo.StepCount(hi=jnp.int32(HI), lo=jnp.int32(LO)),
        critic_normalizer_params=(_norm(rng, obs + env.privileged_obs_size) if priv else None))


def _adam_leaves(tree):
    """A flax PPONetworkParams-like tree in ``ppo.Adam.params``' order."""
    out = []
    for net in ("policy", "value"):
        layers = tree[net]["params"]
        for name in sorted(layers, key=lambda n: int(n.rsplit("_", 1)[1])):
            out += [np.asarray(layers[name]["kernel"]).T, np.asarray(layers[name]["bias"])]
    return out


def _to_flax(leaves, like):
    """Port tensors in ``ppo.Adam.params``' order as a tree like ``like``."""
    it = iter(leaves)
    out = {}
    for net in ("policy", "value"):
        layers = like[net]["params"]
        out[net] = {"params": {}}
        for name in sorted(layers, key=lambda n: int(n.rsplit("_", 1)[1])):
            kernel = jnp.asarray(next(it).numpy().T)
            out[net]["params"][name] = {"kernel": kernel, "bias": jnp.asarray(next(it).numpy())}
    return jnets.PPONetworkParams(policy=out["policy"], value=out["value"])


@pytest.mark.parametrize("priv,clip", [(False, False), (True, True)],
                         ids=["adam-constant-lr", "clip-adam-cosine-privileged-critic"])
def test_jax_train_state_converts_and_resumes(tmp_path, monkeypatch, priv, clip):
    env = PupperV3Env(device="cpu", privileged_obs=priv, **H.env_kwargs())
    jstate = _jax_state(env, priv, clip)
    jcheckpoint.save_checkpoint(ENV_STEPS, jax.device_get(jstate), tmp_path / "jax" / "state")
    out = tmp_path / "port"
    path = _converter().main(["--checkpoint", str(tmp_path / "jax" / "state"), "--out", str(out)])
    assert path == str((out / "state" / str(ENV_STEPS)).resolve())

    # the converted tree, leaf for leaf
    tree = checkpoint.restore_checkpoint(out / "state")
    assert tree["env_steps"] == ENV_STEPS
    assert set(tree) == {"params", "optimizer", "env_steps"} | ({"critic_normalizer"} if priv
                                                                else set())
    adam = (jstate.optimizer_state[1][0] if clip else jstate.optimizer_state[0])
    assert tree["optimizer"]["count"] == int(adam.count) == 3
    for k in ("mu", "nu"):
        want = _adam_leaves(jax.device_get(getattr(adam, k)).__dict__)
        assert [t.shape for t in tree["optimizer"][k]] == [w.shape for w in want]
        for t, w in zip(tree["optimizer"][k], want):
            assert np.array_equal(t.numpy(), w)

    # resume: the first normalizer update and the first Adam step start
    # from the JAX state; the step is held against optax's
    seen = {}
    update, step = running_statistics.update, ppo.Adam.step

    def update_spy(state, batch, *a, **kw):
        seen.setdefault("norms", []).append(state)
        return update(state, batch, *a, **kw)

    def step_spy(self, grads):
        grads = [g.clone() for g in grads]
        seen["before"] = (self.count, [p.detach().clone() for p in self.params],
                          [m.clone() for m in self.mu], [v.clone() for v in self.nu])
        step(self, grads)
        seen["after"] = ([p.detach().clone() for p in self.params], [m.clone() for m in self.mu],
                         [v.clone() for v in self.nu], self.count)
        seen["grads"] = grads
        raise _Stop

    monkeypatch.setattr(running_statistics, "update", update_spy)
    monkeypatch.setattr(ppo.Adam, "step", step_spy)

    def factory(obs_size, action_size, **kw):
        return tnets.make_ppo_networks(obs_size, action_size, POLICY, VALUE, **kw)

    run = dict(TRAIN, network_factory=factory, privileged_critic=priv,
               lr_schedule="cosine" if clip else "constant", max_grad_norm=1.0 if clip else None,
               checkpoint_dir=str(out), resume=True)
    with pytest.raises(_Stop):
        ppo.train(env, num_timesteps=ENV_STEPS + 8, **run)

    jn = jax.device_get(jstate)
    norms = seen["norms"]
    assert len(norms) == 1 + priv
    for got, want in zip(norms, [jn.normalizer_params] + ([jn.critic_normalizer_params]
                                                          if priv else [])):
        for name in ("count", "mean", "summed_variance", "std"):
            assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    count, params, mu, nu = seen["before"]
    assert count == 3
    for got, want in zip(params, _adam_leaves(jn.params.__dict__)):
        assert np.array_equal(got.numpy(), want)
    for got, want in zip(mu + nu, _adam_leaves(adam.mu.__dict__) + _adam_leaves(adam.nu.__dict__)):
        assert np.array_equal(got.numpy(), np.asarray(want))

    # one SGD update against optax's on the same gradients
    opt = _optimizer(clip)
    grads = _to_flax(seen["grads"], jn.params.__dict__)
    updates, new_state = opt.update(grads, jstate.optimizer_state, jstate.params)
    want = _adam_leaves(optax.apply_updates(jstate.params, updates).__dict__)
    new_adam = new_state[1][0] if clip else new_state[0]
    p_after, mu_after, nu_after, count_after = seen["after"]
    assert count_after == int(new_adam.count) == 4
    for got, w in zip(p_after, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-6)
    for got, w in zip(mu_after + nu_after, _adam_leaves(new_adam.mu.__dict__)
                      + _adam_leaves(new_adam.nu.__dict__)):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-6)
    assert any(not torch.equal(a, b) for a, b in zip(p_after, params))

    # the restored count is past a target at it: no training step
    monkeypatch.setattr(ppo.Adam, "step", step)
    seen.clear()
    ppo.train(env, num_timesteps=ENV_STEPS, **run)
    assert "before" not in seen
