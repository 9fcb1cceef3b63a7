"""Team K1's probe builds on the CPU: the phase-cut and layout probes in the
production K1's design (``csrc/probe_physics_team.cuh`` around
``team.physics_step_team_body(s, n, W, cut, sink=True)``).

- The g++ build of the team probe shell (W ``std::thread``s per 32-env
  group, a ``std::barrier`` for each barrier) on 4 warps, for the fk cut at
  2 substeps (the substep loop is light enough that the scheduler
  replicates it in every warp), the efc cut at 1 substep, and P7's team
  build (the fk cut at 2 substeps with its substep loop partitioned,
  ``profile_overhead.P7_*``, 0 replicated operations): bit for bit
  with the one-thread probe's g++ build (``csrc/probe_physics.cuh``) on a
  ragged 37 envs, block-major at 64 envs bit for bit with row-major, and
  both at the parity tolerances against the plain version
  (``soa.physics_step_rows(..., sink=True)``; torch's vectorized CPU
  ``sqrt`` is not correctly rounded, so the plain version is held at
  tolerance, not bit for bit).
- Each cut's rendered warp streams run symbolically in lockstep
  (``test_torch_team.py``'s checker).
- ``cgen.physics_step_program`` and ``team.physics_step_team_body`` with
  their default arguments build today's production program and body, and
  the production team bodies (team K1, K2, K3, K4 at 1 substep) render the
  text whose sha256 the test pins.
- The build records' names, the wrapper on the CPU and the command lines
  without a card.

The chain to JAX is ``test_torch_probes.py::test_phase_cut_matches_jax``,
which holds the plain cut against puppax's ``PHASE_LIMIT`` emission.
"""

import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch.kernels import build, cgen, team
from puppax_torch.physics import soa
from puppax_torch.probes import common, profile_kernel_phases, profile_layout, profile_overhead
from test_torch_team import _lockstep

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parents[1]
WARPS = 4
PRODUCTION = dict(warps=WARPS, loop_weight=team.REPLICATED_LOOP_WEIGHT, cap=team.CAP)
P7 = dict(warps=profile_overhead.P7_WARPS, loop_weight=profile_overhead.P7_LOOP_WEIGHT,
          cap=profile_overhead.P7_CAP)
# (cut, substeps, schedule knobs): production's schedule, and P7's team build
CASES = [("fk", 2, PRODUCTION), ("efc", 1, PRODUCTION), ("fk", 2, P7)]
IDS = ["fk-2substep", "efc-1substep", "fk-2substep-loop-partitioned"]
ROWS_B, BLOCK_B = 37, 64


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probes' C cannot be built on the host")
    cut, n, knobs = request.param
    env = H.torch_env(n_substeps=n)
    s = env._s
    source, stats = team.physics_step_team_body(s, n, knobs["warps"], cut, sink=True,
                                                loop_weight=knobs["loop_weight"], cap=knobs["cap"])
    one = cgen.physics_step_body(s, n, cut, sink=True)
    out = tmp_path_factory.mktemp(f"team_probe_{cut}")
    lib, one_lib = build.build_in_parallel(
        lambda: build.host_library(build.PROBE_PHYSICS_TEAM, source, out),
        lambda: build.host_library(build.PROBE_PHYSICS, one, out))
    # 128 random states (the one-thread shell takes multiples of 128); the
    # team shell runs the first 37 (a ragged 32-env group) and the first 64
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, common.TILE)).numpy()
    blocks = H.to_torch(H.physics_step_blocks(env.model, dr, np.random.RandomState(12),
                                              n=common.TILE))
    return dict(cut=cut, n=n, knobs=knobs, env=env, source=source, stats=stats, one=one, lib=lib,
                one_lib=one_lib, blocks=blocks)


def _rows(s):
    return (s.nq, s.nv, s.nu, s.ndr, s.ncache)


def _team(case, B, layout):
    """The g++ team probe on the first ``B`` envs in ``layout``; its outputs
    as ``(rows, B)``."""
    s = case["env"]._s
    ins = [x[:, :B].contiguous() for x in case["blocks"]]
    if layout == common.BLOCK_MAJOR:
        ins = [common.to_block_major(x, common.TEAM_TILE) for x in ins]
    outs = common.empty_outputs(s, B, "cpu", layout, common.TEAM_TILE)
    rc = case["lib"].probe_physics_team_host(*[t.data_ptr() for t in ins + outs], B, layout,
                                             *_rows(s))
    assert rc == 0
    return outs if layout == common.ROW_MAJOR else [common.from_block_major(x) for x in outs]


def test_team_probe_bit_for_bit_with_one_thread_probe(case):
    """The team probe on a ragged 37 envs equals the one-thread probe's g++
    build on the same envs bit for bit: the same operations with the same
    host math."""
    s, B = case["env"]._s, common.TILE
    outs = common.empty_outputs(s, B, "cpu")
    rc = case["one_lib"].probe_physics_host(
        *[t.data_ptr() for t in list(case["blocks"]) + outs], B, B, common.ROW_MAJOR, *_rows(s))
    assert rc == 0
    for g, w in zip(_team(case, ROWS_B, common.ROW_MAJOR), outs):
        assert torch.equal(g, w[:, :ROWS_B])


def test_team_probe_block_major_equals_row_major(case):
    """Block-major ``(B/32, rows, 32)`` tiles, converted back, equal the
    row-major launch bit for bit; a B that is not a multiple of 32 is
    refused block-major."""
    for g, w in zip(_team(case, BLOCK_B, common.BLOCK_MAJOR),
                    _team(case, BLOCK_B, common.ROW_MAJOR)):
        assert torch.equal(g, w)
    s = case["env"]._s
    ins = [x[:, :ROWS_B].contiguous() for x in case["blocks"]]
    outs = common.empty_outputs(s, ROWS_B, "cpu")
    assert case["lib"].probe_physics_team_host(*[t.data_ptr() for t in ins + outs], ROWS_B,
                                               common.BLOCK_MAJOR, *_rows(s)) != 0


@pytest.mark.parametrize("layout,B", [(common.ROW_MAJOR, ROWS_B), (common.BLOCK_MAJOR, BLOCK_B)])
def test_team_probe_matches_plain(case, layout, B):
    """The team probe against the plain version with the cut and the sink:
    q, v and caches at the parity tolerances; the sink row, a sum of ~1e3
    values of up to ~1e3 whose libm rounding differs, at 1e-4 relative
    plus 1e-3 (as the one-thread probe in ``test_torch_probes.py``)."""
    s = case["env"]._s
    got = _team(case, B, layout)
    want = soa.physics_step_rows(s, case["n"], *[x[:, :B].contiguous() for x in case["blocks"]],
                                 phase_limit=case["cut"], sink=True)
    what = f"g++ team probe vs plain, cut {case['cut']}, {common.LAYOUT_NAMES[layout]}, B={B}"
    H.assert_physics_outputs_close([g.numpy() for g in got[:3]], [w.numpy() for w in want[:3]],
                                   s, what)
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-4, atol=1e-3,
                               err_msg=f"{what}: sink row")


def test_team_cut_streams_in_lockstep(case):
    """The cut program's W streams run in lockstep: every value computed
    once, in one stream, or in all where the schedule replicates it; every
    cross-warp read after its write and a barrier; equal barrier counts;
    the streams' operations the one-thread program's plus the replicated
    ones. Production's fk cut at 2 substeps is the replicated schedule;
    P7's partitions the substep loop and replicates nothing."""
    prog = cgen.physics_step_program(case["env"]._s, case["n"], case["cut"], sink=True)
    knobs = case["knobs"]
    sch = team.Schedule(prog, knobs["warps"], knobs["cap"], loop_weight=knobs["loop_weight"])
    streams = team.render_streams(sch)
    barriers, computed, runs = _lockstep(streams, prog, sch)
    replicated = {a for a, i in sch.info.items() if i.owner == team.REPL}
    assert set(computed) == set(runs)
    for name, by in computed.items():
        assert all(k == runs[name] for k in by.values()), (name, by, runs[name])
        assert len(by) == (sch.W if name in replicated else 1), (name, by)
    stats = case["stats"]
    assert barriers == stats["barriers"] > 0
    assert all(team.stream_barriers(x) == barriers for x in streams)
    ops = [team.stream_ops(x) for x in streams]
    assert ops == stats["stream_ops"]
    assert sum(ops) == stats["ops_per_env"] + sch.replicated_ops() == \
        stats["ops_per_env"] + stats["replicated_ops"]
    if knobs == P7:  # the substep loop is split: its carries cross in shared slots
        assert stats["replicated_ops"] == 0 and max(ops) < stats["ops_per_env"]
        assert any(sy.what == "ploop" for st in sch.regions[0].stages for sy in st.syncs)
    elif case["cut"] == "fk":  # the substep loop runs whole in every warp
        assert stats["replicated_ops"] > stats["ops_per_env"]
        assert max(ops) > stats["ops_per_env"] / 2
    else:
        assert max(ops) < stats["ops_per_env"] / 2
    assert stats["shared_bytes"] <= team.SHARED_BUDGET


def test_team_probe_counts_the_one_thread_cuts_operations(case):
    """The build record's ``ops_per_env`` of a team cut (``team.render``'s)
    is the one-thread probe body's ``cgen.op_count``: the same program."""
    assert case["stats"]["ops_per_env"] == cgen.op_count(case["one"])
    assert case["stats"]["warps"] == case["knobs"]["warps"]
    assert f"cut after phase {case['cut']}, sink row" in case["source"].splitlines()[0]
    assert "(PP_PARAMS, int B, int b, int warp" in case["source"]


def _inner(body):
    """The statement lines of a one-thread body (between its signature and
    its closing brace)."""
    lines = body.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("PUPPAX_HD"))
    return lines[start + 1 : -1]


def test_default_programs_are_production():
    """With the default arguments the program is the one-thread K1's body
    line for line, and the team body is the pre-cut definition's rendering
    (``team_body`` of that program under ``PS_PARAMS``) byte for byte; a cut
    program with the sink is the one-thread probe body's."""
    s = H.torch_env()._s
    body_lines = _inner(cgen.physics_step_body(s, 1))
    assert cgen.physics_step_program(s, 1).lines == body_lines
    assert cgen.physics_step_program(s, 1, None, False).lines == body_lines
    want = team.team_body(cgen.physics_step_program(s, 1), WARPS, "physics_step_team_body",
                          "PS_PARAMS", "physics-step emission (n_substeps=1)")
    assert team.physics_step_team_body(s, 1, WARPS) == want
    assert team.physics_step_team_body(s, 1, WARPS, None, False) == want
    cut = cgen.physics_step_program(s, 1, "compos", sink=True)
    assert cut.lines == _inner(cgen.physics_step_body(s, 1, "compos", sink=True))
    assert any(line.strip().startswith("sink_out[0 * B + b] = ") for line in cut.lines)


# sha256 of the production team bodies rendered for the test env (1 substep,
# episode length 1000), as the scheduler rendered them before it took its
# replicated-loop threshold as an argument
PRODUCTION_SHA256 = {
    "K1": "5c252340cbc6e18a543bbc35d78035f3b2826d434a694e22452fac8ebbf770c5",
    "K2": "88e765fe2b8361142d2a363ac79b51005e613238b92cc41e4d68f99af6602c70",
    "K3": "f817628f28f1ab62e1171a734a356fed32d38ba76dfcde3e9895b812f0f1263b",
    "K4": "39be34a2870de9f274301866608e99183cfddc5c8db2fd67587f3dcce0dc1a67",
}


def test_production_team_bodies_render_as_before():
    """Team K1, K2, K3 and K4 at their production W (and K4's MLP rows)
    render byte for byte the text they rendered before the probes could
    move the replicated-loop threshold: the same sha256."""
    env = H.torch_env()
    s, es, w = env._s, env._es, build.TEAM_WARPS
    bodies = {
        "K1": team.physics_step_team_body(s, 1, w["physics_step_team"]),
        "K2": team.env_step_team_body(s, es, 1, w["env_step_team"]),
        "K3": team.wrapped_step_team_body(s, es, 1, 1000, w["wrapped_step_team"]),
        "K4": cgen.fused_unroll_team_body(s, es, 1, 1000, w["fused_unroll_team"],
                                          build.K4_MLP_ROWS),
    }
    got = {k: hashlib.sha256(src.encode()).hexdigest() for k, (src, _) in bodies.items()}
    assert got == PRODUCTION_SHA256


def test_p7_wrapper_and_records_on_the_cpu():
    """P7's two designs on CPU tensors run the plain fk cut; the team
    build's record names its knobs, apart from P1's team fk cut and from
    the one-thread cut."""
    env = H.torch_env()
    s, B = env._s, common.TILE
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.to_torch(H.physics_step_blocks(env.model, dr, np.random.RandomState(14), n=B))
    want = soa.physics_step_rows(s, 1, *blocks, phase_limit="fk", sink=True)
    for team_build in (False, True):
        outs = common.empty_outputs(s, B, "cpu")
        profile_overhead.fk_step(s, 1, blocks, outs, team_build)
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert profile_overhead.fk_team_record() == "probe_physics_team[fk loop weight 0 cap 128]"
    assert build.team_probe_variant("fk") == "fk"
    assert build.team_probe_variant(None, 8, 0, 16) == "full 8 warps loop weight 0 cap 16"
    assert profile_overhead.FK_TEAM != common.k1_probe_name("fk", team=True)


def test_one_stream_keeps_one_case():
    """``profile_team.one_stream``, P7's per-stream SASS build: the body with
    only warp w's case keeps that case's statements line for line and
    empties every other case; with None every case is empty."""
    from puppax_torch.probes import profile_team

    source, stats = team.physics_step_team_body(H.torch_env()._s, 1, P7["warps"], "fk",
                                                sink=True, loop_weight=P7["loop_weight"],
                                                cap=P7["cap"])
    prog = cgen.physics_step_program(H.torch_env()._s, 1, "fk", sink=True)
    streams = team.render_streams(team.Schedule(prog, P7["warps"], P7["cap"],
                                                loop_weight=P7["loop_weight"]))
    empty = profile_team.one_stream(source, None)
    assert all(f"  case {w}: {{\n  }} break;\n" in empty for w in range(P7["warps"]))
    for w, lines in enumerate(streams):
        one = profile_team.one_stream(source, w)
        assert "\n".join(lines) in one and len(one) == len(empty) + len("\n".join(lines)) + 1
    assert stats["stream_ops"] == [team.stream_ops(x) for x in streams]


def test_team_probe_records_and_names():
    """Each team cut is its own build record and launch name, apart from
    the one-thread probes' and production's."""
    assert build.record_name(build.PROBE_PHYSICS_TEAM, "fk") == "probe_physics_team[fk]"
    names = {profile_kernel_phases.record(cut, d) for cut in soa.PHASES
             for d in profile_kernel_phases.DESIGNS}
    assert len(names) == 2 * len(soa.PHASES)
    assert profile_kernel_phases.record(None, "team") == "probe_physics_team[full]"
    assert build.record_name(build.PHYSICS_STEP_TEAM) == "physics_step_team"
    launch_names = {common.k1_probe_name(cut, layout, team=t) for cut in soa.PHASES
                    for layout in common.LAYOUT_NAMES for t in (False, True)}
    assert len(launch_names) == 4 * len(soa.PHASES)
    assert common.k1_probe_name("fk", common.BLOCK_MAJOR, team=True) == \
        "k1_team_probe_fk_block_major"
    assert common.k1_probe_name(None) == "k1_probe_full"
    assert profile_layout.PHASES == ("fk", None)


def test_team_probe_wrapper_on_the_cpu():
    """On CPU tensors ``physics_probe_team`` runs the plain version in
    either layout (32-env tiles); it refuses wrong shapes and other
    devices."""
    env = H.torch_env()
    s, B = env._s, BLOCK_B
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.to_torch(H.physics_step_blocks(env.model, dr, np.random.RandomState(13), n=B))
    want = soa.physics_step_rows(s, 1, *blocks, phase_limit="comvel", sink=True)
    row = common.empty_outputs(s, B, "cpu")
    common.physics_probe_team(s, 1, blocks, row, "comvel")
    tiles = common.empty_outputs(s, B, "cpu", common.BLOCK_MAJOR, common.TEAM_TILE)
    assert tiles[0].shape == (B // common.TEAM_TILE, s.nq, common.TEAM_TILE)
    common.physics_probe_team(s, 1, [common.to_block_major(x, common.TEAM_TILE) for x in blocks],
                              tiles, "comvel", common.BLOCK_MAJOR)
    for r, t, w in zip(row, tiles, want):
        assert torch.equal(r, w) and torch.equal(common.from_block_major(t), w)
    ragged = [x[:, :ROWS_B].contiguous() for x in blocks]
    common.physics_probe_team(s, 1, ragged, common.empty_outputs(s, ROWS_B, "cpu"), "comvel")
    with pytest.raises(ValueError):  # row-major blocks given as block-major
        common.physics_probe_team(s, 1, blocks, row, "comvel", common.BLOCK_MAJOR)
    with pytest.raises(ValueError):  # 128-env tiles are the one-thread probe's
        common.physics_probe_team(s, 1, [common.to_block_major(x) for x in blocks],
                                  common.empty_outputs(s, B, "cpu", common.BLOCK_MAJOR),
                                  "comvel", common.BLOCK_MAJOR)
    meta = [torch.empty(x.shape, device="meta") for x in blocks]
    with pytest.raises(ValueError, match="unsupported device"):
        common.physics_probe_team(s, 1, meta, [torch.empty(x.shape, device="meta") for x in row])


@pytest.mark.parametrize("probe", ["profile_kernel_phases", "profile_layout",
                                   "profile_team --kernel P7"])
def test_probe_cli_exits_1_without_a_card(probe):
    """``python -m puppax_torch.probes.<probe>`` exits 1, printing no
    table, where no CUDA device is visible."""
    name, *args = probe.split()
    proc = subprocess.run([sys.executable, "-m", f"puppax_torch.probes.{name}", *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no CUDA device found" in proc.stderr
    assert "us/step" not in proc.stdout
