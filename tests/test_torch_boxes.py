"""The sphere-box pair in the emitter and the kernels (obstacle terrain).

The emission runs a box model's sphere-box pairs as loops over a constant
table of the boxes (``soa._BoxRows``), not pair by pair as the JAX
emission unrolls them. On a 3-box model within a metre of the origin (1
substep, bases placed so that spheres penetrate boxes, JAX's DR rows):

* the plain K3 (``wrapped_step_rows``) against JAX's
  ``wrapped_step_rows_xla``, and the plain K2 (``env_step_rows``) against
  JAX's XLA step core on the envs the MJX caps keep whole, at qpos 5e-5 /
  scaled qvel 5e-4 / obs and rewards 2e-4 / done exact;
* the g++ builds of team K3[boxes] at W = 6 and W = 4 and of team
  K2[boxes] at W = 6, bit for bit with the g++ one-thread K3 and K2 (the
  same operations in the same order, the team's arrays in its global
  scratch), and team K3 against JAX at those tolerances;
* the bodies' size: run8's one-thread K3 (20 boxes, 5 substeps) within 1.5x
  the flat body's 68,082 lines, and the 2-box and the 20-box bodies
  differing only in the table, the loops' trip counts and the arrays'
  sizes;
* the statics (the box table, the build variants), and run8 building and
  stepping on the physics-only lane (K1) and the fused lane (K4), whose
  parity is ``tests/test_torch_box_lanes.py``'s.
"""

import difflib
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import soa_env as jax_soa_env
from puppax_torch import random
from puppax_torch.configs import experiment as exp
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.kernels import build, cgen, team
from puppax_torch.model import mjcf, tables
from puppax_torch.physics import soa

torch.set_num_threads(1)

NB = 40  # a full 32-env group and a ragged one
OTHER_W = 4
RUN8 = os.path.join(os.path.dirname(__file__), "..", "dev", "run_configs",
                    "run8_500m_obstacles.json")


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    """The 3-box model's env in both packages (1 substep), its K3 inputs
    with the even envs' bases over the boxes, and JAX's wrapped step."""
    cfg = H.box_model_config(3)
    path = tables.write_config_tables(cfg, str(tmp_path_factory.mktemp("boxes") / "t.json"))
    tenv = PupperV3Env(device="cpu", tables=path, **H.env_kwargs(1))
    jenv = JaxEnv(path=None, xml_string=tables.config_xml(cfg), reward_config=get_config(),
                  **H.env_kwargs(1))
    s, es = tenv._s, tenv._es
    dr = H.jax_dr_rows(jenv._cv_core._s, H.jax_dr_model(jenv, num_envs=NB), n=NB)
    rng = np.random.RandomState(0)
    blocks = H.wrapped_step_blocks(s, es, tenv.model, dr, rng, n=NB)
    blocks[0] = H.place_over_boxes(tenv.model, blocks[0].T, rng, range(0, NB, 2)).T.copy()
    want = [np.asarray(w) for w in jax_soa_env.wrapped_step_rows_xla(
        jenv._cv_core._s, jenv._cv_core._es, 1, H.EPISODE_LENGTH, *blocks)]
    return tenv, jenv, blocks, want


def test_box_statics_and_table(boxes):
    tenv = boxes[0]
    s = tenv._s
    bx = s.boxes
    assert (bx.n, len(bx.spheres), bx.first) == (3, 8, 32)
    assert [p.kind for p in s.pairs].count("bs") == 24 and soa.soa_supported(tenv.model)
    for k in range(bx.n):
        for j, sp in enumerate(bx.spheres):
            p = s.pairs[bx.first + k * 8 + j]
            assert (p.geom1, p.sphere_body, p.solref) == (sp.geom1, sp.sphere_body, sp.solref)
            assert bx.table[k] == tuple(c for row in p.box_R for c in row) + p.box_pos + \
                p.box_half
    assert soa.indexed_dr_rows(s) == [s.dr_rows["pair_mu"][0] + 32 + i for i in range(8, 24)]
    assert build.model_variant(s) == "boxes"
    assert build.record_name(build.WRAPPED_STEP_TEAM, build.model_variant(s)) == \
        "wrapped_step_team[boxes]"
    assert s.hess.sum() == soa._Static(H.torch_env().model).hess.sum()


def test_box_k3_torch_rows_match_jax(boxes):
    tenv, _, blocks, want = boxes
    s, es = tenv._s, tenv._es
    got = [g.numpy() for g in soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH,
                                                        *H.to_torch(blocks))]
    H.assert_wrapped_outputs_close(got, want, s, es, soa_env.aux_row_map(es),
                                   "box torch rows vs JAX")
    # the check is not vacuous: spheres penetrate boxes in most placed envs
    assert H.box_contacts(tenv.model, blocks[0].T).sum() >= NB // 4


def test_box_k2_torch_rows_match_jax_step_core(boxes):
    """The plain K2 against JAX's XLA step core (the MJX caps) on the envs
    the caps keep whole, the contact report's box rows included."""
    from test_torch_env_step import _cache_block, _env_in, _noise_dict, _out_block

    tenv, jenv, blocks, _ = boxes
    s, es = tenv._s, tenv._es
    q, v, act, env_b, noi = blocks[:5]
    dr = H.jax_dr_rows(jenv._cv_core._s, jenv.model, n=NB)  # the core steps the model as built
    core = jax.jit(jax.vmap(lambda *a: jenv._step_core(jenv.model, *a)))
    ps, env_out = jax.tree_util.tree_map(np.asarray, core(
        q.T, v.T, act.T, _env_in(es, env_b), _noise_dict(es, noi)))
    got = [g.numpy() for g in soa_env.env_step_rows(s, es, 1, *H.to_torch(blocks[:5] + [dr]))]
    want = [ps.qpos.T, ps.qvel.T, _cache_block(s, ps), _out_block(es, env_out)]
    r0, n = s.cache_rows["con_dist"]
    kinds = np.array([p.kind for p in s.pairs])
    pen = got[2][r0:r0 + n] < 0
    counts = np.stack([pen[kinds == k].sum(0) for k in ("ps", "ss", "bs")], 1)
    keep = H.within_caps(tenv.model, counts)
    boxed = keep & (counts[:, 2] > 0)
    assert boxed.sum() >= 8, counts
    H.assert_env_outputs_close([g[:, keep] for g in got], [w[:, keep] for w in want], s, es,
                               "box env_step_rows vs XLA core")


@pytest.fixture(scope="module")
def gxx(boxes, tmp_path_factory):
    """g++ builds of the one-thread K3 and K2, team K3 at W = 6 and W = 4 and
    team K2 at W = 6, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated source cannot be built on the host")
    tenv = boxes[0]
    s, es, L = tenv._s, tenv._es, H.EPISODE_LENGTH
    out = tmp_path_factory.mktemp("boxes_gxx")
    W = build.TEAM_WARPS["wrapped_step_team"]
    jobs = {
        ("K3", 0): (build.WRAPPED_STEP, lambda: cgen.wrapped_step_body(s, es, 1, L)),
        ("K2", 0): (build.ENV_STEP, lambda: cgen.env_step_body(s, es, 1)),
    }
    for w in (W, OTHER_W):
        jobs[("K3", w)] = (build.WRAPPED_STEP_TEAM,
                           lambda w=w: team.wrapped_step_team_body(s, es, 1, L, w))
    jobs[("K2", W)] = (build.ENV_STEP_TEAM, lambda: team.env_step_team_body(s, es, 1, W))
    bodies = {key: make() for key, (_, make) in jobs.items()}
    stats = {key: b[1] for key, b in bodies.items() if isinstance(b, tuple)}
    libs = build.build_in_parallel(*[
        (lambda key=key: build.host_library(
            jobs[key][0], bodies[key][0] if isinstance(bodies[key], tuple) else bodies[key],
            out / f"{key[0]}{key[1]}"))
        for key in jobs])
    return dict(zip(jobs, libs)), stats


def _run_host(fn, blocks, out_rows):
    outs = [torch.empty((k, NB), dtype=torch.float32) for k in out_rows]
    assert fn(*[t.data_ptr() for t in H.to_torch(blocks) + outs], NB) == 0
    return outs


@pytest.mark.parametrize("kernel, warps", [
    ("K3", build.TEAM_WARPS["wrapped_step_team"]), ("K3", OTHER_W),
    ("K2", build.TEAM_WARPS["env_step_team"])])
def test_box_team_gxx_bit_for_bit(boxes, gxx, kernel, warps):
    tenv, _, blocks, want = boxes
    s, es = tenv._s, tenv._es
    libs, stats = gxx
    assert H.box_contacts(tenv.model, blocks[0].T).sum() >= NB // 4
    st = stats[(kernel, warps)]
    assert st["warps"] == warps and st["scratch_bytes_per_env"] > 0
    assert st["shared_bytes"] <= team.SHARED_BUDGET
    if kernel == "K3":
        out_rows = soa_env.block_rows(s, es)[1]
        got = _run_host(libs[(kernel, warps)].wrapped_step_team_host, blocks, out_rows)
        one = _run_host(libs[(kernel, 0)].wrapped_step_host, blocks, out_rows)
    else:
        out_rows = soa_env.env_block_rows(s, es)[1]
        got = _run_host(libs[(kernel, warps)].env_step_team_host, blocks[:6], out_rows)
        one = _run_host(libs[(kernel, 0)].env_step_host, blocks[:6], out_rows)
    for i, (g, o) in enumerate(zip(got, one)):
        assert torch.equal(g, o), f"g++ team {kernel}[boxes] (W={warps}) vs one-thread: output {i}"
    if kernel == "K3":
        H.assert_wrapped_outputs_close([g.numpy() for g in got], want, s, es,
                                       soa_env.aux_row_map(es), "g++ team K3[boxes] vs JAX")


def _run8():
    with open(RUN8) as f:
        return exp.from_dict(json.load(f)).env


def _k3_body(tables_path: str) -> str:
    """The production one-thread K3 (5 substeps, episode 1000) of the
    model of ``tables_path``."""
    env = PupperV3Env(device="cpu", tables=tables_path)
    return cgen.wrapped_step_body(env._s, env._es, 5, 1000)


def test_box_body_size_does_not_grow_with_the_boxes(tmp_path):
    run8 = _k3_body(mjcf.config_tables_path(_run8()))
    assert run8.count("\n") <= 1.5 * 68082, run8.count("\n")
    two = _k3_body(tables.write_config_tables(H.box_model_config(2), str(tmp_path / "t.json")))
    diff = [d for d in difflib.unified_diff(two.splitlines(), run8.splitlines(), lineterm="", n=0)
            if d[:1] in "+-" and not d.startswith(("+++", "---"))]
    table = re.compile(r"^[+-](  [-(\d].*f[,}]|// The obstacle boxes' table, \d+ rows|"
                       r"(__constant__ |static const )float box_table_(dev|host)\[\d+\])")
    size = re.compile(r"^[+-] *(float a\d+\[\d+\];|"
                      r"for \(int ([ir]\d+) = 0; \2 < \d+; \+\+\2\) \{)$")
    assert all(table.match(d) or size.match(d) for d in diff), \
        [d[:120] for d in diff if not (table.match(d) or size.match(d))][:5]
    assert abs(run8.count("\n") - two.count("\n")) <= 2 * (20 - 2)
    # the bound's count weights the box loops by their trips: 20 boxes
    # count 5.7x the flat body's 347,225 operations, 2 boxes fewer
    assert cgen.op_count(two) < cgen.op_count(run8) == 1963685


def test_box_lanes_build_and_step_run8(monkeypatch):
    """run8's env (20 boxes; 1 substep to keep the plain versions short)
    builds and steps on the physics-only lane (its batched step is K1's, on
    a box static) and on the fused lane (one T = 1 unroll through
    ``fused_unroll.unroll``), on the CPU; float32 never reaches the torch
    ``pipeline_step``."""
    from dataclasses import replace

    from puppax_torch.physics import pipeline
    from puppax_torch.train import networks

    cfg = replace(_run8(), environment_timestep=H.PHYSICS_DT)
    monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
    po = PupperV3Env.from_config(cfg, device="cpu")
    monkeypatch.delenv("PUPPAX_SOA_ENV")
    assert not po._use_soa_env and po._cv_step.s.boxes.n == 20
    assert build.model_variant(po._cv_step.s) == "boxes"
    monkeypatch.setattr(pipeline, "pipeline_step", lambda *a: pytest.fail("pipeline_step"))
    monkeypatch.setattr(soa_env, "env_step", lambda *a: pytest.fail("K2 lane taken"))
    wrapped = wrap_for_training(po, H.EPISODE_LENGTH)
    state = wrapped.reset(H.env_keys(2), caches=True)
    before = soa.step_batched.launches
    state = wrapped.step(state, torch.zeros(2, po.action_size))
    assert soa.step_batched.launches == before  # the plain version on the CPU
    assert torch.isfinite(state.obs).all() and state.pipeline_state.contact_dist.shape == (2, 192)

    monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")
    env = PupperV3Env.from_config(cfg, device="cpu")
    calls = []
    unroll = fused_unroll.unroll
    monkeypatch.setattr(fused_unroll, "unroll", lambda *a: calls.append(a[6].shape[1])
                        or unroll(*a))
    monkeypatch.setattr(soa_env, "wrapped_step", lambda *a: pytest.fail("K3 lane taken"))
    wrapped = wrap_for_training(env, H.EPISODE_LENGTH)
    policy = networks.make_ppo_networks(env.observation_size, env.action_size, (32, 32),
                                        (32, 32), device="cpu").policy_network
    final, data = FastLane(wrapped).unroll(wrapped.reset(H.env_keys(2)), (None, policy),
                                           random.key(1), 1)
    assert calls == [2] and torch.isfinite(final.obs).all() and data.reward.shape == (1, 2)


def test_bodies_rendered_in_processes_are_the_same_text(boxes):
    """``build.render_in_processes`` (the smoke renders its first batch
    that way) gives each library call the body this process renders, under
    the key its build looks up."""
    tenv = boxes[0]
    s, es = tenv._s, tenv._es
    calls = [(build.env_step_library, (s, es, 1)),
             (build.wrapped_step_team_library, (s, es, 1, H.EPISODE_LENGTH, OTHER_W))]
    build.render_in_processes(*calls, workers=2)
    try:
        keys = [build._instead("key", c) for c in calls]
        assert build._RENDERED[keys[0]][0] == cgen.env_step_body(s, es, 1)
        assert build._RENDERED[keys[1]][0] == team.wrapped_step_team_body(
            s, es, 1, H.EPISODE_LENGTH, OTHER_W)
    finally:
        build._RENDERED.clear()
