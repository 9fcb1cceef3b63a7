"""The frozen reference (``portbench/reference/refport``) against the
port's plain path today, at a small size on the CPU: the same keys, DR,
reset, weights, draws and SGD pass, and a wrapped env step that the
kernels' emission (the port's plain version of K3, the second witness)
gives within the check's tolerances."""

from __future__ import annotations

import functools
import json
import os

import pytest
import torch

from conftest import BENCH, TINY_TRAIN


def _config(name):
    c = json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))
    c["experiment"]["train"].update(TINY_TRAIN)
    return c


@pytest.fixture(scope="module")
def pair():
    import refcell

    from portbench import program

    config = _config("default")
    ctx = program.Context(config, {}, 1234567891, torch.device("cpu"))
    cfg, env, wrapped, lane, keys = program.build_env(ctx, 4)
    # the reference makes the recorded envs alone: envs 1 and 3 of 4
    ref = refcell.Reference(config, 4, 1234567891, torch.tensor([1, 3]))
    return cfg, env, wrapped, lane, keys, ref


def test_keys_dr_and_reset(pair):
    from portbench import program

    cfg, env, wrapped, lane, keys, ref = pair
    for k in ("network", "env", "dr", "key"):
        assert torch.equal(keys[k], ref.keys[k])
    got = program.start_blocks(lane, wrapped, wrapped.reset(keys["env"]), ref.cols)
    want = ref.start_blocks()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_weights_and_policy(pair):
    cfg, env, wrapped, lane, keys, ref = pair
    nets = __import__("portbench.program", fromlist=["x"]).make_networks(cfg, env, keys["network"],
                                                                        "cpu")
    for a, b in zip(nets.policy_network.parameters(), ref.nets.policy_network.parameters()):
        assert torch.equal(a, b)
    from puppax_torch.train import running_statistics

    norm = running_statistics.init_state(env.observation_size, "cpu")
    obs = torch.randn(env.observation_size, 4, generator=torch.Generator().manual_seed(0))
    eps = torch.randn(env.action_size, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = lane.policy_rows(norm, nets.policy_network)(obs, eps)
    want = ref.policy_rows(obs, eps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def _witness_steps(lane, wrapped, keys, ref, steps):
    """``steps`` wrapped steps of the port's emission from the reset, each
    judged against the reference's float64 step from the same state."""
    import compare

    from puppax_torch.env import soa_env

    state = wrapped.reset(keys["env"])
    carry = lane.carry_from_state(state)
    q, v, env_rows, wrap = carry["q"], carry["v"], carry["env"], carry["wrap"]
    rng, n = state.info["rng"], q.shape[1]
    g = torch.Generator().manual_seed(2)
    items = compare.Items()
    for t in range(steps):
        after, noise, _ = lane.draw_noise_block(rng, 1)
        act = torch.tanh(torch.randn(12, n, generator=g))
        got = soa_env.wrapped_step(lane.s, lane.es, lane.n_substeps, 1000, q, v, act, env_rows,
                                   noise[0].contiguous(), carry["dr"], carry["first"], wrap)
        ins = {"q": q, "v": v, "act": act, "env": env_rows, "first": carry["first"],
               "wrap": wrap}
        want = ref.step(ins, ref.noise(rng, 1)[0], torch.arange(n))
        compare.step_items(items, ref, got, want, [], f"step {t}")
        q, v, env_rows, wrap = got[:4]
        rng = after
    return items


def test_draws_and_wrapped_step(pair):
    import refcell

    cfg, env, wrapped, lane, keys, ref = pair
    state = wrapped.reset(keys["env"])
    for k in range(2):
        key = torch.tensor([7, k], dtype=torch.int32)
        assert torch.equal(lane.draw_eps(key, 4, 3), ref.eps(key, 3))
    after, noise, _ = lane.draw_noise_block(state.info["rng"], 3)
    from refport.env import soa_env as ref_layout

    want = torch.stack([ref_layout.noise_block(ref.es, d) for d in ref.noise(state.info["rng"], 3)])
    assert torch.equal(noise, want)
    assert torch.equal(after[ref.cols], ref.rng_after(3))
    # the envs of the whole batch, so that the step's states are the port's
    full = refcell.Reference(_config("default"), 4, 1234567891, torch.arange(4))
    items = _witness_steps(lane, wrapped, keys, full, 3)
    assert items.count == 12 and items.n_outside == 0, items.notes


def test_box_terrain_step_matches_the_emission():
    """run8's box pairs: the float64 pipeline with every pair against the
    emission's loops over the box table."""
    import refcell

    from portbench import program

    config = _config("run8")
    ctx = program.Context(config, {}, 2147483659, torch.device("cpu"))
    cfg, env, wrapped, lane, keys = program.build_env(ctx, 2)
    ref = refcell.Reference(config, 2, 2147483659, torch.arange(2))
    items = _witness_steps(lane, wrapped, keys, ref, 1)
    assert items.count == 2 and items.n_outside == 0, items.notes


def test_sgd_pass_matches_the_learners():
    import learner
    import refcell

    from portbench import program
    from puppax_torch.parallel import mesh as mesh_lib
    from puppax_torch.train import ppo, running_statistics
    from puppax_torch.train.acting import Transition

    config = _config("default")
    ctx = program.Context(config, {}, 99, torch.device("cpu"))
    cfg, env, wrapped, lane, keys = program.build_env(ctx, 4)
    t = cfg.train
    nets = program.make_networks(cfg, env, keys["network"], "cpu")
    params = list(nets.policy_network.parameters()) + list(nets.value_network.parameters())
    ref = refcell.Reference(config, 4, 99, torch.arange(4))
    lrn = learner.Learner(ref, ref.cfg, 4)
    opt = ppo.Adam(params, ppo.lr_schedule_fn(t.learning_rate, t.lr_schedule,
                                              t.lr_final_fraction, 1000))
    lrn.adam.lr = opt.lr
    g = torch.Generator().manual_seed(3)
    T, n = t.unroll_length, t.batch_size * t.num_minibatches
    batch = {"observation": torch.randn(T, n, 72, generator=g),
             "next_observation": torch.randn(T, n, 72, generator=g),
             "reward": torch.randn(T, n, generator=g),
             "discount": (torch.rand(T, n, generator=g) > 0.1).float(),
             "truncation": torch.zeros(T, n),
             "raw_action": torch.randn(T, n, 12, generator=g),
             "log_prob": torch.randn(T, n, generator=g)}
    data = Transition(observation=batch["observation"], action=torch.tanh(batch["raw_action"]),
                      reward=batch["reward"], discount=batch["discount"],
                      next_observation=batch["next_observation"], truncation=batch["truncation"],
                      policy_extras={"raw_action": batch["raw_action"],
                                     "log_prob": batch["log_prob"]}, extras={})
    norm = running_statistics.update(running_statistics.init_state(72, "cpu"),
                                     batch["observation"])
    key_sgd, _ = lrn.unroll_keys_next()
    _, key_prog, _ = ppo.training_step_keys(random_split(keys["key"]))
    assert torch.equal(key_sgd, key_prog)
    sums = {}
    ppo.sgd_pass(nets, opt, (norm, None), data, key_prog, t.entropy_cost,
                 mesh=mesh_lib.make_env_mesh(["cpu"]), batch_size=t.batch_size,
                 num_minibatches=t.num_minibatches, sums=sums, discounting=t.discounting,
                 gae_lambda=t.gae_lambda, clipping_epsilon=t.clipping_epsilon,
                 reward_scaling=t.reward_scaling)
    loss = lrn.step(batch, key_sgd)
    assert loss == pytest.approx(float(sums["total_loss"]) / t.num_minibatches, rel=1e-5)
    for a, b in zip(params, lrn.params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def random_split(key):
    from puppax_torch import random

    return random.split(key).unbind(0)[1]
