"""The port's initial network weights against flax's for the same key.

``networks.MLP`` draws each ``hidden_i`` kernel from the key flax's
``module.init(key, ...)`` gives that Dense (``networks.flax_param_key``:
the module path and the ``make_rng`` count folded in by their sha1), as
jax's ``lecun_uniform`` in float32, with zero biases. The policy and value
params of ``make_ppo_networks(..., key=k)`` must equal, bit for bit,
``puppax``'s ``policy_network.init(split(k)[0])`` and
``value_network.init(split(k)[1])`` (``puppax/train/ppo.py:591-594``), at
the default widths and with a privileged critic's wider value net; and
``ppo.train``'s networks, as it builds them from a seed, must equal the
JAX learner's initial params for that seed. ``params_from_jax`` carries
JAX's weights across to the same state dict.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puppax.train import networks as jnets
from puppax_torch import random
from puppax_torch.train import networks as tnets
from puppax_torch.train import ppo

torch.set_num_threads(1)

OBS, PRIV, ACT = 72, 34, 12


class _Built(Exception):
    pass


def _assert_equal(port: torch.nn.Module, flax_params):
    want = tnets.params_from_jax(jax.tree_util.tree_map(np.asarray, flax_params))
    got = port.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def _jax_init(seed, priv, policy=(32, 32, 32, 32), value=(256, 256, 256, 256, 256)):
    """puppax's initial params for ``seed`` (``ppo.py:204-205, 591-594``)."""
    jn = jnets.make_ppo_networks(OBS, ACT, policy, value, privileged_size=priv)
    _, network_key, _, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    key_policy, key_value = jax.random.split(network_key)
    return jn.policy_network.init(key_policy), jn.value_network.init(key_value)


def test_fold_in_static_matches_flax():
    from flax.core import scope as fscope

    key = jax.random.PRNGKey(11)
    for path, count in ((("hidden_0",), 1), (("hidden_3",), 2), (("a", "hidden_12"), 7)):
        want = np.asarray(jax.random.key_data(fscope._fold_in_static(key, path + (count,))))
        got = tnets.flax_param_key(random.key(11), path, count)
        assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32)), path
    # the first 4 sha1 bytes, big-endian (the hash flax folds)
    d = hashlib.sha1(b"hidden_0\x01").digest()
    want = jax.random.fold_in(key, np.uint32(int.from_bytes(d[:4], "big")))
    got = tnets.flax_param_key(random.key(11), ("hidden_0",), 1)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(jax.random.key_data(want)).view(np.uint32))


@pytest.mark.parametrize("fan_in,fan_out", [(72, 32), (256, 1), (106, 256), (1, 3)])
def test_lecun_uniform_matches_jax(fan_in, fan_out):
    key = jax.random.PRNGKey(fan_in * 1000 + fan_out)
    want = np.asarray(jax.nn.initializers.lecun_uniform()(key, (fan_in, fan_out), jnp.float32))
    got = tnets.lecun_uniform(random.from_key_data(np.asarray(key)), fan_in, fan_out)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("priv", [0, PRIV], ids=["plain-critic", "privileged-critic"])
@pytest.mark.parametrize("seed", [0, 5])
def test_make_ppo_networks_init_is_flax(seed, priv):
    jpolicy, jvalue = _jax_init(seed, priv)
    keys = ppo.init_keys(seed, 4, False, "cpu")
    nets = tnets.make_ppo_networks(OBS, ACT, device="cpu", key=keys["network"],
                                   privileged_size=priv)
    _assert_equal(nets.policy_network, jpolicy)
    _assert_equal(nets.value_network, jvalue)
    assert not torch.equal(nets.policy_network.hidden_0.weight,
                           nets.policy_network.hidden_1.weight[:, :OBS])


def test_train_initial_params_are_jax(monkeypatch):
    """``ppo.train`` builds its networks from ``init_keys``' network key;
    they are captured as built (before any update) and held against the
    JAX learner's initial params for the same seed, with the privileged
    critic's wider value net."""
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.configs import get_config

    env = PupperV3Env(reward_config=get_config(), action_scale=0.75, observation_history=2,
                      privileged_obs=True, device="cpu")
    assert env.observation_size == OBS
    seen = {}

    def factory(obs_size, action_size, **kw):
        nets = tnets.make_ppo_networks(obs_size, action_size, (32, 16), (32,), **kw)
        seen["nets"], seen["priv"] = nets, kw.get("privileged_size", 0)
        raise _Built

    with pytest.raises(_Built):
        ppo.train(env, num_timesteps=8, episode_length=8, num_envs=4, batch_size=2,
                  num_minibatches=2, unroll_length=2, seed=3, network_factory=factory,
                  privileged_critic=True, device="cpu")
    priv = env.privileged_obs_size
    assert seen["priv"] == priv
    jpolicy, jvalue = _jax_init(3, priv, (32, 16), (32,))
    _assert_equal(seen["nets"].policy_network, jpolicy)
    _assert_equal(seen["nets"].value_network, jvalue)
