"""The physics-only and fused lanes on a box model (obstacle terrain).

run8's terrain trains on three lanes: the default one (K3 and K2), the
physics-only one (``PUPPAX_SOA_ENV=off``: the env layer in torch around
K1) and the fused one (``PUPPAX_FUSED_UNROLL=on``: K4 in the rollout). On a
3-box model within a metre of the origin (1 substep, the even envs' bases
placed so that spheres penetrate boxes,
``torch_port_helpers.place_over_boxes``):

* the plain K1 (``soa.physics_step_rows``) against JAX's XLA
  ``pipeline_step`` on the envs the MJX caps keep whole, at qpos 5e-5 /
  scaled qvel 5e-4 and the caches' tolerances, sphere-box rows among them;
  the DR batch's gap is the emission's line search, as
  ``tests/test_torch_physics_step.py`` shows for the flat model;
* the port's physics-only env step (the plain K1 and the torch env layer)
  against the plain K2[boxes] on the same inputs and draws: obs and reward
  2e-4, done exact, neither K2 nor the torch ``pipeline_step`` reached;
* the fused lane (the plain K4) at T = 2 against JAX's
  ``FastLane(mode="xla")`` and against the port's K3 lane on the same
  draws, at the tolerances of ``tests/test_torch_fused_unroll.py``;
* the g++ builds of team K1[boxes] (W = 4) and team K4[boxes] (W = 6, T =
  2) bit for bit with the g++ one-thread K1 and K4 (the team bodies' arrays
  in their global scratch; team K4 reuses it in every step);
* ``ppo.train`` on both lanes.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fused_unroll as fused_tests
import torch_port_helpers as H
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import domain_randomization as jdr
from puppax.env import rollout as jrollout
from puppax.env import wrappers as jwrappers
from puppax.physics import pipeline as jpipe
from puppax.train import running_statistics as jstats
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.kernels import build, cgen, team
from puppax_torch.model import tables
from puppax_torch.physics import pipeline, soa
from puppax_torch.train import networks as tnets
from puppax_torch.train import ppo
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

NB = 40  # a full 32-env group and a ragged one
T = 2
OBS = 72


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    """The 3-box model's tables, JAX's env of it and the port's env on each
    lane (1 substep)."""
    cfg = H.box_model_config(3)
    path = tables.write_config_tables(cfg, str(tmp_path_factory.mktemp("box_lanes") / "t.json"))
    jenv = JaxEnv(path=None, xml_string=tables.config_xml(cfg), reward_config=get_config(),
                  **H.env_kwargs(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PUPPAX_SOA_ENV", "off")  # read at the env's construction
        physics_only = PupperV3Env(device="cpu", tables=path, **H.env_kwargs(1))
    fused = PupperV3Env(device="cpu", tables=path, **H.env_kwargs(1))
    assert not physics_only._use_soa_env and fused._use_soa_env
    return path, jenv, physics_only, fused


def _box_rows_active(s, con_dist) -> np.ndarray:
    """Per env of a ``(npair, n)`` block of distances: a sphere-box row < 0."""
    nbs = s.boxes.n * len(s.boxes.spheres)
    return (np.asarray(con_dist)[s.boxes.first:s.boxes.first + nbs] < 0).any(0)


def _kind_counts(s, con_dist) -> np.ndarray:
    kinds = np.array([p.kind for p in s.pairs])
    pen = np.asarray(con_dist) < 0
    return np.stack([pen[kinds == k].sum(0) for k in ("ps", "ss", "bs")], 1)


def _k1_blocks(env, jenv, rng):
    dr = H.jax_dr_rows(jenv._cv_core._s, jenv.model, n=NB)
    blocks = H.physics_step_blocks(env.model, dr, rng, n=NB)
    blocks[0] = H.place_over_boxes(env.model, blocks[0].T, rng, range(0, NB, 2)).T.copy()
    return blocks


def test_k1_plain_matches_jax_pipeline(boxes, monkeypatch):
    """The plain K1[boxes] against JAX's XLA ``pipeline_step`` (1 substep)
    on the envs within the MJX caps, at least 8 of them with a sphere in a
    box; the line search run to convergence on both sides of the gap."""
    from test_torch_physics_step import _cache_block

    _, jenv, env, _ = boxes
    s = env._s
    blocks = _k1_blocks(env, jenv, np.random.RandomState(0))
    q, v, c = (b.T for b in blocks[:3])
    step = jax.jit(jax.vmap(lambda qp, qv, ct: jpipe.pipeline_step(
        jenv.model, jpipe._zeros_state(jenv.model, qp, qv), ct, 1)))
    ps = jax.tree_util.tree_map(np.asarray, step(q, v, c))
    monkeypatch.setattr(soa, "LS_EXPAND_ITERS", 40)
    monkeypatch.setattr(soa, "LS_ILLINOIS_ITERS", 200)
    got = [g.numpy() for g in soa.physics_step_rows(s, 1, *H.to_torch(blocks))]
    r0, n = s.cache_rows["con_dist"]
    counts = _kind_counts(s, got[2][r0:r0 + n])
    keep = H.within_caps(env.model, counts)
    assert (keep & (counts[:, 2] > 0)).sum() >= 8, counts
    want = [ps.qpos.T, ps.qvel.T, _cache_block(s, ps)]
    H.assert_physics_outputs_close([g[:, keep] for g in got], [w[:, keep] for w in want], s,
                                   "K1[boxes] plain vs XLA pipeline_step")


def test_physics_only_step_matches_k2(boxes, monkeypatch):
    """One env step on the physics-only lane (the plain K1 inside
    ``_step_core``) against the fused lane's plain K2[boxes], on the same
    state, action and draws: obs and reward 2e-4, done exact, the contact
    report's box rows among the caches."""
    _, _, po, k2 = boxes
    keys = H.env_keys(NB, seed=4)
    state = po.reset_from_draws(po.draw_reset(keys))
    rng = np.random.RandomState(1)
    qpos = H.place_over_boxes(po.model, state.qpos.numpy(), rng, range(0, NB, 2))
    state = state.replace(qpos=torch.from_numpy(qpos))
    action = torch.from_numpy(rng.uniform(-1, 1, (NB, 12)).astype(np.float32))
    noise = po.draw_step_noise(state.info["rng"])
    want = k2.step_from_draws(state, action, noise)
    monkeypatch.setattr(soa_env, "env_step", lambda *a: pytest.fail("K2 lane taken"))
    monkeypatch.setattr(pipeline, "pipeline_step", lambda *a: pytest.fail("pipeline_step"))
    assert po._cv_step.s is not None and po._cv_step.s.boxes.n == 3
    got = po.step_from_draws(state, action, noise)
    close = np.testing.assert_allclose
    assert torch.equal(got.done, want.done)
    close(got.obs.numpy(), want.obs.numpy(), atol=2e-4, rtol=0, err_msg="obs")
    close(got.reward.numpy(), want.reward.numpy(), atol=2e-4, rtol=0, err_msg="reward")
    close(got.qpos.numpy(), want.qpos.numpy(), atol=1e-5, rtol=0, err_msg="qpos")
    for name in ("contact_dist", "contact_pos", "xpos", "site_xpos"):
        close(getattr(got.pipeline_state, name).numpy(),
              getattr(want.pipeline_state, name).numpy(), atol=1e-5, rtol=0, err_msg=name)
    for name in ("last_contact", "step"):
        assert torch.equal(got.info[name], want.info[name]), name
    active = _box_rows_active(po._s, got.pipeline_state.contact_dist.t().numpy())
    assert active.sum() >= NB // 4, active


@pytest.fixture(scope="module")
def fused_lanes(boxes):
    """JAX's xla lane and the port's fused lane at T = 2 on a DR'd reset
    with env 1 done, envs 2-3 one step before the episode limit and the
    even envs' bases over the boxes, and the port's K3 lane on the same
    draws."""
    path, jenv, _, env = boxes
    B = H.B
    jwrapped = jwrappers.wrap_for_training(
        jenv, H.EPISODE_LENGTH, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), B))
    jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), B))
    steps = np.zeros(B, np.float32)
    steps[2:4] = H.EPISODE_LENGTH - 1
    done = np.zeros(B, np.float32)
    done[1] = 1.0
    qpos = H.place_over_boxes(env.model, np.asarray(jstate.pipeline_state.qpos),
                              np.random.RandomState(2), range(0, B, 2))
    assert H.box_contacts(env.model, qpos).sum() >= 2
    jstate = jstate.replace(
        done=jnp.asarray(done), info=dict(jstate.info, steps=jnp.asarray(steps)),
        pipeline_state=jstate.pipeline_state.replace(qpos=jnp.asarray(qpos)))
    params, policy = fused_tests._policy("elu")
    norm = jstats.init_state(OBS).replace(mean=jnp.linspace(-0.1, 0.1, OBS),
                                          std=jnp.linspace(0.9, 1.1, OBS))
    key = jax.random.PRNGKey(11)
    jlane = jrollout.FastLane(jwrapped, mode="xla")
    jfinal, jdata = fused_tests._np(jlane.unroll(jstate, (norm, params), key, T, jax.nn.elu))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, :B]

    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(env, H.EPISODE_LENGTH,
                                 randomization_fn=lambda m, keys: m.with_leaves(**leaves),
                                 randomization_keys=H.env_keys(B))
    tlane = FastLane(twrapped)
    draws = (torch.from_numpy(np.array(noise)),
             torch.from_numpy(fused_tests._eps_from_key(key, T, B)),
             torch.from_numpy(np.array(last_kick)))
    tstate = state_from_jax(fused_tests._np(jstate))
    params_t = (tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std)), policy)
    with pytest.MonkeyPatch.context() as mp:
        k3 = tlane.unroll_from_draws(tstate, params_t, *draws)
        mp.setenv("PUPPAX_FUSED_UNROLL", "on")
        mp.setattr(soa_env, "wrapped_step", lambda *a: pytest.fail("K3 lane taken"))
        k4 = tlane.unroll_from_draws(tstate, params_t, *draws)
    return (jfinal, jdata), k4, k3


def test_fused_lane_matches_jax(fused_lanes):
    """The fused lane's plain K4[boxes] against JAX's xla FastLane, at the
    tolerances of ``test_torch_fused_unroll.py::test_fused_lane_matches_jax``."""
    (jfinal, jdata), (tfinal, tdata), _ = fused_lanes
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


def test_fused_lane_matches_k3_lane(fused_lanes):
    """The same draws through K3's lane and K4's on the box model: the
    folded normalizer and the in-order dot products are the only
    differences (float32 rounding). A sphere pressed into a box carries an
    action's rounding (~2e-7) into qvel at the contact's stiffness (up to
    5e-5 of 3.5 here), so qvel is held scaled by max(1, the env's largest
    |qvel|) at 5e-5, a tenth of the parity tolerance."""
    _, (tfinal, tdata), (kfinal, kdata) = fused_lanes
    close = lambda a, b, what: torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=what)  # noqa: E731
    for name in ("observation", "next_observation", "action", "reward"):
        close(getattr(tdata, name), getattr(kdata, name), name)
    close(tdata.policy_extras["log_prob"], kdata.policy_extras["log_prob"], "log_prob")
    assert torch.equal(tdata.discount, kdata.discount)
    assert torch.equal(tdata.truncation, kdata.truncation)
    for name in ("qpos", "obs"):
        close(getattr(tfinal, name), getattr(kfinal, name), name)
    scale = kfinal.qvel.abs().amax(1, keepdim=True).clamp(min=1.0)
    torch.testing.assert_close(tfinal.qvel / scale, kfinal.qvel / scale, atol=5e-5, rtol=0,
                               msg="scaled qvel")
    for name in ("steps", "step", "last_contact"):
        assert torch.equal(tfinal.info[name], kfinal.info[name]), name


@pytest.fixture(scope="module")
def gxx(boxes, tmp_path_factory):
    """g++ builds of the one-thread K1 and K4 and of team K1 (W = 4) and
    team K4 (W = 6) of the box model, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated source cannot be built on the host")
    env = boxes[3]
    s, es, L = env._s, env._es, H.EPISODE_LENGTH
    out = tmp_path_factory.mktemp("box_lanes_gxx")
    w1, w4 = build.TEAM_WARPS["physics_step_team"], build.TEAM_WARPS["fused_unroll_team"]
    team_k1 = team.physics_step_team_body(s, 1, w1)
    team_k4 = cgen.fused_unroll_team_body(s, es, 1, L, w4, build.K4_MLP_ROWS)
    jobs = {
        ("K1", 0): (build.PHYSICS_STEP, cgen.physics_step_body(s, 1)),
        ("K1", w1): (build.PHYSICS_STEP_TEAM, team_k1[0]),
        ("K4", 0): (build.FUSED_UNROLL, cgen.fused_unroll_body(s, es, 1, L)),
        ("K4", w4): (build.FUSED_UNROLL_TEAM, team_k4[0]),
    }
    libs = build.build_in_parallel(*[
        (lambda key=key: build.host_library(jobs[key][0], jobs[key][1],
                                            out / f"{key[0]}_{key[1]}"))
        for key in jobs])
    return dict(zip(jobs, libs)), {"K1": team_k1[1], "K4": team_k4[1]}


def test_team_k1_gxx_bit_for_bit(boxes, gxx):
    """Team K1[boxes] at W = 4 against the one-thread K1[boxes]: the same
    operations in the same order, the team's arrays in its global scratch."""
    _, jenv, env, _ = boxes
    s = env._s
    libs, stats = gxx
    w = build.TEAM_WARPS["physics_step_team"]
    assert stats["K1"]["warps"] == w and stats["K1"]["scratch_bytes_per_env"] > 0
    assert stats["K1"]["shared_bytes"] <= team.SHARED_BUDGET
    blocks = H.to_torch(_k1_blocks(env, jenv, np.random.RandomState(3)))
    assert H.box_contacts(env.model, blocks[0].t().numpy()).sum() >= NB // 4
    out_rows = soa.physics_block_rows(s)[1]
    outs = {}
    for key, entry in (((("K1", w)), "physics_step_team_host"), (("K1", 0), "physics_step_host")):
        outs[key] = [torch.empty((k, NB), dtype=torch.float32) for k in out_rows]
        assert getattr(libs[key], entry)(*[t.data_ptr() for t in blocks + outs[key]], NB) == 0
    for i, (g, o) in enumerate(zip(outs[("K1", w)], outs[("K1", 0)])):
        assert torch.equal(g, o), f"g++ team K1[boxes] vs one-thread: output {i}"
    r0, n = s.cache_rows["con_dist"]
    assert _box_rows_active(s, outs[("K1", w)][2][r0:r0 + n].numpy()).sum() >= NB // 4


def test_team_k4_gxx_bit_for_bit(boxes, gxx):
    """Team K4[boxes] at W = 6 against the one-thread K4[boxes] over T = 2
    steps (the box arrays' scratch reused by the second step, the carry
    through its own scratch set), bases over the boxes."""
    env = boxes[3]
    s, es = env._s, env._es
    libs, stats = gxx
    w = build.TEAM_WARPS["fused_unroll_team"]
    assert stats["K4"]["scratch_bytes_per_env"] > 0
    layers, blocks = H.fused_unroll_inputs(env, NB, T, "elu", H.EPISODE_LENGTH)
    q = H.place_over_boxes(env.model, blocks[0].t().numpy(), np.random.RandomState(5),
                           range(0, NB, 2))
    assert H.box_contacts(env.model, q).sum() >= NB // 4
    blocks[0] = torch.from_numpy(q.T.copy())
    got = fused_unroll.kernel_call(libs[("K4", w)].fused_unroll_team_host, s, es, "elu", layers,
                                   fused_unroll.team_weights(layers), *blocks)
    one = fused_unroll.kernel_call(libs[("K4", 0)].fused_unroll_host, s, es, "elu", layers,
                                   fused_unroll.one_thread_weights(layers), *blocks)
    for i, (g, o) in enumerate(zip(got, one)):
        assert (g is None and o is None) or torch.equal(g, o), \
            f"g++ team K4[boxes] vs one-thread: output {i}"


@pytest.mark.parametrize("lane", ["physics-only", "fused"])
def test_ppo_train_on_the_box_lanes(boxes, tmp_path, capsys, monkeypatch, lane):
    """``ppo.train`` on the 3-box model on the physics-only lane (the
    standard lane's unrolls around the plain K1, no K2, K3 or K4) and on the
    fused lane (every unroll through ``fused_unroll.unroll``, none through
    K3): the lane line, and it trains."""
    path = boxes[0]
    calls = []
    if lane == "physics-only":
        monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
        step = soa.step_batched
        monkeypatch.setattr(soa, "step_batched", lambda *a: calls.append(a[1].shape[1])
                            or step(*a))
        for owner, name in ((soa_env, "env_step"), (soa_env, "wrapped_step"),
                            (fused_unroll, "unroll")):
            monkeypatch.setattr(owner, name, lambda *a: pytest.fail("a kernel lane taken"))
        line = "OFF (PUPPAX_SOA_ENV=off; devices=1)"
    else:
        monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")
        unroll = fused_unroll.unroll
        monkeypatch.setattr(fused_unroll, "unroll", lambda *a: calls.append(a[6].shape[1])
                            or unroll(*a))
        monkeypatch.setattr(soa_env, "wrapped_step", lambda *a: pytest.fail("K3 lane taken"))
        line = "ON (ok; devices=1, fused-unroll=ON)"
    env = PupperV3Env(device="cpu", tables=path, **H.env_kwargs(1))

    def factory(obs, act, device=None, key=None):
        return tnets.make_ppo_networks(obs, act, (32, 32), (32, 32), device=device, key=key)

    _, (norm, _), metrics = ppo.train(
        env, num_timesteps=8, episode_length=8, num_envs=4, num_eval_envs=2, unroll_length=2,
        batch_size=2, num_minibatches=2, num_updates_per_batch=1, num_evals=2,
        network_factory=factory, device="cpu", checkpoint_dir=str(tmp_path))
    assert f"[puppax.ppo] rollout fast lane: {line}" in capsys.readouterr().out
    # physics-only: K1 at the 4 training envs and the 2 eval envs; fused: one
    # unroll of the 4 training envs (the evaluator runs K2's plain version)
    assert set(calls) == {4, 2} if lane == "physics-only" else calls == [4]
    assert float(norm.count) == 2 * 4
    assert np.isfinite(metrics["training/total_loss"])
    assert 0 < metrics["eval/avg_episode_length"] <= 8


def test_bind_scratch_frees_no_scratch_a_capture_may_hold(monkeypatch):
    """``build.bind_scratch`` at 128, 4096 and again 128 envs: a larger B
    binds a larger scratch and keeps the one it replaced (a CUDA graph
    captured at 128 may hold its pointer); a smaller B keeps the larger one;
    a body without arrays binds none."""
    from types import SimpleNamespace

    monkeypatch.setattr(build, "_SCRATCH", {})
    monkeypatch.setattr(build, "_RETIRED_SCRATCH", [])
    bound = []
    lib = SimpleNamespace(physics_step_team_scratch_rows=lambda: 3,
                          physics_step_team_set_scratch=lambda p: bound.append(p.value))
    cpu = torch.device("cpu")
    for B in (128, 4096, 128):
        build.bind_scratch(lib, build.PHYSICS_STEP_TEAM, B, cpu)
    first, now = build._RETIRED_SCRATCH, build._SCRATCH[id(lib)]
    assert len(bound) == 2 and bound[1] == now.data_ptr() and now.numel() == 3 * 4096
    assert len(first) == 1 and first[0].numel() == 3 * 128 and bound[0] == first[0].data_ptr()
    flat = SimpleNamespace(physics_step_team_scratch_rows=lambda: 0)
    build.bind_scratch(flat, build.PHYSICS_STEP_TEAM, 4096, cpu)
    assert id(flat) not in build._SCRATCH


def test_start_batch_takes_its_keys_in_the_callers_thread(boxes, monkeypatch):
    """``build.start_batch`` takes the calls' build keys before it returns
    (a key lookup in the background would meet the caller's own library
    calls) and hands them to ``build_batch`` in its thread."""
    env = boxes[3]
    s, es = env._s, env._es
    calls = [(build.physics_step_team_library, (s, 1)),
             (build.fused_unroll_team_library, (s, es, 1, H.EPISODE_LENGTH))]
    seen = []
    monkeypatch.setattr(build, "build_batch", lambda *c, keys: seen.append((c, keys)) or "libs")
    assert build.start_batch(*calls).result() == "libs"
    assert build._INSTEAD is None
    assert seen == [(tuple(calls), [build._instead("key", c) for c in calls])]
    assert seen[0][1][0][0] == "physics_step_team[boxes]"
