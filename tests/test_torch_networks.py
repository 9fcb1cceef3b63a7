"""The port's policy/value MLPs and NormalTanh head against puppax's flax.

Weights made by flax are carried across with ``params_from_jax``; the
same observations and sampling eps go through both. Tolerances as
``tests/test_rollout.py:139-172``: action and raw action 1e-6, log_prob
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.train import networks as jnets
from puppax.train import running_statistics as jstats
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.train import networks as tnets
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

OBS, ACT = 72, 12


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    jn = jnets.make_ppo_networks(OBS, ACT, policy_hidden_layer_sizes=(32, 32),
                                 value_hidden_layer_sizes=(64, 64), activation=jax.nn.elu)
    pparams = jn.policy_network.init(jax.random.PRNGKey(7))
    vparams = jn.value_network.init(jax.random.PRNGKey(8))
    norm = jstats.init_state(OBS).replace(
        mean=jnp.linspace(-0.1, 0.1, OBS), std=jnp.linspace(0.9, 1.1, OBS)
    )
    tn = tnets.make_ppo_networks(OBS, ACT, (32, 32), (64, 64), activation="elu", device="cpu")
    tn.policy_network.load_state_dict(tnets.params_from_jax(_np_tree(pparams)))
    tn.value_network.load_state_dict(tnets.params_from_jax(_np_tree(vparams)))
    tnorm = tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std))
    rng = np.random.RandomState(0)
    obs = rng.uniform(-1, 1, (H.B, OBS)).astype(np.float32)
    eps = rng.normal(0, 1, (H.B, ACT)).astype(np.float32)
    return jn, pparams, vparams, norm, tn, tnorm, obs, eps


def _jax_reference(jn, pparams, norm, obs, eps):
    logits = jn.policy_network.apply(norm, pparams, jnp.asarray(obs))
    loc, scale = jnp.split(logits, 2, axis=-1)
    pre = loc + (jax.nn.softplus(scale) + 0.001) * jnp.asarray(eps)
    return np.asarray(jnp.tanh(pre)), np.asarray(pre), np.asarray(
        jn.action_distribution.log_prob(logits, pre)
    )


def test_param_tree_layout(nets):
    """hidden_i naming and (out, in) weights: the flax tree round-trips."""
    _, pparams, *_ = nets
    sd = tnets.params_from_jax(_np_tree(pparams))
    assert sorted(sd) == ["hidden_0.bias", "hidden_0.weight", "hidden_1.bias",
                          "hidden_1.weight", "hidden_2.bias", "hidden_2.weight"]
    assert tuple(sd["hidden_2.weight"].shape) == (2 * ACT, 32)


def test_policy_and_head_match_flax(nets):
    jn, pparams, _, norm, tn, tnorm, obs, eps = nets
    act_ref, pre_ref, lp_ref = _jax_reference(jn, pparams, norm, obs, eps)
    with torch.no_grad():
        logits = tn.policy_network(tstats.normalize(torch.from_numpy(obs), tnorm))
        dist = tn.action_distribution
        loc, scale = dist.loc_scale(logits)
        pre = loc + scale * torch.from_numpy(eps)
        lp = dist.log_prob(logits, pre)
    np.testing.assert_allclose(dist.postprocess(pre).numpy(), act_ref, atol=1e-6)
    np.testing.assert_allclose(pre.numpy(), pre_ref, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), lp_ref, atol=1e-4)


def test_value_network_matches_flax(nets):
    jn, _, vparams, norm, tn, tnorm, obs, _ = nets
    want = np.asarray(jn.value_network.apply(norm, vparams, jnp.asarray(obs)))
    with torch.no_grad():
        got = tn.value_network(tstats.normalize(torch.from_numpy(obs), tnorm))[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_fast_lane_policy_rows_match_flax(nets):
    """The lane's feature-major policy apply (obs rows in, action rows
    out) equals the batch-major flax policy with the same eps."""
    jn, pparams, _, norm, tn, tnorm, obs, eps = nets
    act_ref, pre_ref, lp_ref = _jax_reference(jn, pparams, norm, obs, eps)
    lane = FastLane(wrap_for_training(H.torch_env(), H.EPISODE_LENGTH))
    apply = lane.policy_rows(tnorm, tn.policy_network)
    with torch.no_grad():
        act, raw, lp = apply(torch.from_numpy(obs.T.copy()), torch.from_numpy(eps.T.copy()))
    np.testing.assert_allclose(act.numpy().T, act_ref, atol=1e-6)
    np.testing.assert_allclose(raw.numpy().T, pre_ref, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), lp_ref, atol=1e-4)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
