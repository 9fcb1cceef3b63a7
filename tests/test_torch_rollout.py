"""The port's rollout fast lane against puppax's, end to end.

Both lanes start from the same DR reset state (``puppax``'s, carried
across with ``state_from_jax``), run the same policy weights
(``params_from_jax``) and consume the same draws: ``puppax``'s
``draw_noise_block`` rows and the sampling eps of its key chain
(``rollout.py:495-504``), fed to the port's ``unroll_from_draws``. The
JAX lane runs the kernel's program as XLA ops (``mode="xla"``), the port
its plain version. Env 1 enters done (the AutoReset prologue) and envs
2-3 one step before the episode limit (truncation). Tolerances as
``tests/test_rollout.py:199-250``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env import domain_randomization as jdr
from puppax.env import rollout as jrollout
from puppax.env import wrappers as jwrappers
from puppax.train import networks as jnets
from puppax.train import running_statistics as jstats
from puppax_torch import random
from puppax_torch.env import soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.train import networks as tnets
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

T = 2


@pytest.fixture(scope="module")
def lanes():
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

    nets = jnets.make_ppo_networks(jenv.observation_size, jenv.action_size,
                                   policy_hidden_layer_sizes=(32, 32), activation=jax.nn.elu)
    params = nets.policy_network.init(jax.random.PRNGKey(7))
    norm = jstats.init_state(jenv.observation_size).replace(
        mean=jnp.linspace(-0.1, 0.1, jenv.observation_size),
        std=jnp.linspace(0.9, 1.1, jenv.observation_size),
    )
    key = jax.random.PRNGKey(11)
    jlane = jrollout.FastLane(jwrapped, mode="xla")
    jfinal, jdata = jlane.unroll(jstate, (norm, params), key, T, jax.nn.elu)

    # the draws the JAX lane consumed
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, : H.B]

    def key_step(k, _):
        cur, nxt = jax.random.split(k)
        return nxt, cur

    _, used = jax.lax.scan(key_step, key, (), length=T)
    eps = jax.vmap(lambda k: jax.random.normal(k, (H.B, jenv.action_size)))(used)

    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(
        H.torch_env(), H.EPISODE_LENGTH,
        randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )
    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    tn = tnets.make_ppo_networks(jenv.observation_size, jenv.action_size, (32, 32),
                               device="cpu")
    tn.policy_network.load_state_dict(
        tnets.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    )
    tnorm = tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std))
    tlane = FastLane(twrapped)
    tfinal, tdata = tlane.unroll_from_draws(
        tstate, (tnorm, tn.policy_network), torch.from_numpy(np.array(noise)),
        torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(last_kick)),
    )
    jnp_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    # the same unroll from the keys: the state's per-env keys and the
    # unroll's key, the port drawing for itself
    seeded = tlane.unroll(tstate, (tnorm, tn.policy_network),
                          random.from_key_data(np.asarray(key)), T)
    # T = 3 steps of the per-env chains (rollout.py:366-404)
    jkeys3, tiles3, kick3 = jlane.draw_noise_block(jstate.info["rng"], 3)
    chains = (np.asarray(jkeys3), np.asarray(tiles3).reshape(3, tiles3.shape[1], -1)[:, :, : H.B],
              np.asarray(kick3), tlane.draw_noise_block(tstate.info["rng"], 3))
    return (jnp_tree(jfinal), jnp_tree(jdata), tfinal, tdata, seeded, chains, tlane, twrapped,
            tn, tnorm)


def test_transitions_match(lanes):
    jfinal, jdata, tfinal, tdata, *_ = lanes
    atol = 2e-4
    close = np.testing.assert_allclose
    close(tdata.observation.numpy(), jdata.observation, atol=atol, err_msg="observation")
    close(tdata.next_observation.numpy(), jdata.next_observation, atol=atol,
          err_msg="next_observation")
    close(tdata.action.numpy(), jdata.action, atol=atol, err_msg="action")
    close(tdata.policy_extras["raw_action"].numpy(), jdata.policy_extras["raw_action"],
          atol=atol, err_msg="raw_action")
    close(tdata.policy_extras["log_prob"].numpy(), jdata.policy_extras["log_prob"],
          atol=1e-2, err_msg="log_prob")
    close(tdata.reward.numpy(), jdata.reward, atol=1e-3, err_msg="reward")
    np.testing.assert_array_equal(tdata.discount.numpy(), jdata.discount)
    np.testing.assert_array_equal(tdata.truncation.numpy(), jdata.truncation)
    # the episode-limit envs truncate on the first step
    assert (jdata.truncation[0, 2:4] == 1).all() and (jdata.discount[0, 2:4] == 0).all()


def test_final_state_matches(lanes):
    jfinal, _, tfinal, *_ = lanes
    atol = 2e-4
    np.testing.assert_allclose(tfinal.qpos.numpy(), jfinal.pipeline_state.qpos, atol=atol)
    np.testing.assert_allclose(tfinal.obs.numpy(), jfinal.obs, atol=atol)
    np.testing.assert_array_equal(tfinal.done.numpy(), jfinal.done)
    np.testing.assert_array_equal(tfinal.info["steps"].numpy(), jfinal.info["steps"])
    np.testing.assert_array_equal(tfinal.info["step"].numpy(), jfinal.info["step"])
    np.testing.assert_array_equal(tfinal.info["kick"].numpy(), jfinal.info["kick"])
    for name in ("command", "feet_air_time", "last_act", "last_vel"):
        np.testing.assert_allclose(tfinal.info[name].numpy(), jfinal.info[name], atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(tfinal.metrics["total_dist"].numpy(),
                               jfinal.metrics["total_dist"], atol=1e-4)


def test_noise_chains_seed_for_seed(lanes):
    """``draw_noise_block`` at B = 8, T = 3 on the envs' keys: the keys after
    T steps, the last kick and every noise row bit for bit with the JAX
    lane's (no row is a normal draw), but the resampled orientation, a
    rotation of two draws (``ops/math.py``, whose multiply-adds XLA
    contracts), within 2e-7."""
    *_, chains, tlane, _, _, _ = lanes
    jkeys, jnoise, jkick, (tkeys, tnoise, tkick) = chains
    np.testing.assert_array_equal(tkeys.numpy().view(np.uint32), jkeys)
    np.testing.assert_array_equal(tkick.numpy().view(np.uint32), jkick.view(np.uint32))
    r0, n = tlane.es.noise_rows["resample_ori"]
    draws = np.r_[0:r0, r0 + n : tnoise.shape[1]]
    np.testing.assert_array_equal(tnoise.numpy()[:, draws].view(np.uint32),
                                  jnoise[:, draws].view(np.uint32))
    np.testing.assert_allclose(tnoise.numpy()[:, r0 : r0 + n], jnoise[:, r0 : r0 + n],
                               atol=2e-7, rtol=0)


def test_unroll_from_keys_matches_jax(lanes):
    """``FastLane.unroll`` from the same keys as the JAX lane (the state's
    ``info["rng"]`` and the unroll's key): its transitions at
    ``test_transitions_match``'s tolerances, its final keys bit for bit."""
    jfinal, jdata, _, _, (sfinal, sdata), *_ = lanes
    close = np.testing.assert_allclose
    for name in ("observation", "next_observation", "action"):
        close(getattr(sdata, name).numpy(), getattr(jdata, name), atol=2e-4, err_msg=name)
    close(sdata.policy_extras["raw_action"].numpy(), jdata.policy_extras["raw_action"],
          atol=2e-4, err_msg="raw_action")
    close(sdata.policy_extras["log_prob"].numpy(), jdata.policy_extras["log_prob"], atol=1e-2)
    close(sdata.reward.numpy(), jdata.reward, atol=1e-3, err_msg="reward")
    np.testing.assert_array_equal(sdata.discount.numpy(), jdata.discount)
    np.testing.assert_array_equal(sdata.truncation.numpy(), jdata.truncation)
    np.testing.assert_array_equal(sfinal.info["rng"].numpy().view(np.uint32),
                                  jfinal.info["rng"])
    np.testing.assert_array_equal(sfinal.info["kick"].numpy(), jfinal.info["kick"])


def test_unroll_draws_from_generator(lanes):
    """``unroll`` draws its noise from the state's per-env keys and its eps
    from the unroll's key (the threefry keys that replaced the generator):
    shapes, finite values, determinism per seed, the keys carried on, and
    no kernel launch on CPU."""
    *_, tlane, twrapped, tn, tnorm = lanes
    launches = soa_env.wrapped_step.launches

    def run(seed):
        key_env, key = random.split(random.key(seed)).unbind(0)
        state = twrapped.reset(random.split(key_env, H.B))
        final, data = tlane.unroll(state, (tnorm, tn.policy_network), key, T)
        keys, _, _ = tlane.draw_noise_block(state.info["rng"], T)
        assert torch.equal(final.info["rng"], keys)
        return final, data

    final, data = run(1)
    obs = tlane.env.observation_size
    assert data.observation.shape == (T, H.B, obs)
    assert data.action.shape == (T, H.B, 12) and data.reward.shape == (T, H.B)
    assert data.policy_extras["log_prob"].shape == (T, H.B)
    for x in (data.observation, data.reward, data.policy_extras["log_prob"], final.qpos):
        assert torch.isfinite(x).all()
    assert (data.action.abs() <= 1).all()
    _, again = run(1)
    assert torch.equal(again.observation, data.observation)
    _, other = run(2)
    assert not torch.equal(other.observation, data.observation)
    assert soa_env.wrapped_step.launches == launches


def test_reset_refuses_another_batch(lanes):
    *_, twrapped, _, _ = lanes
    with pytest.raises(ValueError):
        twrapped.reset(H.env_keys(H.B + 1))
