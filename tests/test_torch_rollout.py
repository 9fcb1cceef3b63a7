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
        randomization_fn=lambda m, g, n: m.with_leaves(**leaves),
        generator=torch.Generator().manual_seed(0), num_envs=H.B,
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
    return jnp_tree(jfinal), jnp_tree(jdata), tfinal, tdata, tlane, twrapped, tn, tnorm


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


def test_unroll_draws_from_generator(lanes):
    """``unroll`` draws its noise and eps from the generator: shapes,
    finite values, determinism per seed, and no kernel launch on CPU."""
    *_, tlane, twrapped, tn, tnorm = lanes
    launches = soa_env.wrapped_step.launches

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        state = twrapped.reset(H.B, generator=g)
        return tlane.unroll(state, (tnorm, tn.policy_network), generator=g, T=T)

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
        twrapped.reset(H.B + 1, generator=torch.Generator())
