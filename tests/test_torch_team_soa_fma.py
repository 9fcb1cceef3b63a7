"""Probe P12 as a team kernel and P3's redesigns, on the CPU.

- Team P12 (``csrc/probe_soa_team.cuh`` around
  ``pallas_soa_probe.soa_substep_team_body``) built with g++ (W
  ``std::thread``s per 32-env group, a ``std::barrier`` for each barrier),
  at the probe's schedule (2 warps, no stage budget: 5 barriers) and at 4
  warps with a stage budget of 16 (each round split across the warps: 271
  barriers): bit for bit with the one-thread P12's g++ build
  (``csrc/probe_soa.cuh``) and with the program run on the host's math
  functions, at a ragged B = 37 and at B = 64; within rtol 1e-6 of the
  plain version as it is (torch's vectorized CPU ``sqrt`` is not correctly
  rounded and its ``cos`` / ``sin`` part from libm's in the last bit, as
  ``test_torch_probes_prototypes.py`` says); within atol 1e-6, rtol 1e-5
  of the TPU kernel's body (``dev/pallas_soa_probe.py::substep_like_kernel``
  on ``jnp`` arrays through stand-in refs), that test's tolerance.
- The team streams in lockstep (``test_torch_team.py``'s checker): the
  same barrier count in every stream, the operations the one-thread
  body's.
- The chain's redesign (``fma_chain_ilp_host``: 8 interleaved elements per
  thread on a grid of 96 host threads, so the strides and ragged passes
  are the card's code) bit for bit with ``chain_rows`` and with the
  one-element kernel's g++ build, and the plain loop bit for bit with
  ``dev/probe_fma_fusion.py``'s ``muladd_chain`` / ``add_chain`` /
  ``mul_chain`` run eagerly in JAX (op by op, each rounded) at small K.
- The SASS reader on a listing in ``cuobjdump``'s format, the test of
  whether a build contracts every pair, and the issue floors.
- Team bodies render the same text under any ``PYTHONHASHSEED``.
- Build records and launch names kept apart, the wrappers' checks and the
  new command-line flags without a card.
"""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch.kernels import build, cgen, team
from puppax_torch.physics import soa
from puppax_torch.probes import common, pallas_soa_probe as P, probe_fma_fusion as F
from test_torch_probes_prototypes import _exact_sqrt, _libm
from test_torch_team import _lockstep

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# (warps, stage budget): the probe's schedule, and a schedule that splits
# each round across the warps
VARIANTS = ((P.TEAM_WARPS, P.TEAM_CAP), (4, 16))
IDS = [f"{w}w-cap{c}" for w, c in VARIANTS]
CPU_MATH_RTOL = 1e-6  # the plain version's torch math against the host's (see above)


def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probes' C cannot be built on the host")


def _dev(name: str, monkeypatch, argv=None):
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    spec = importlib.util.spec_from_file_location(f"dev_{name}", REPO / "dev" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def soa_libs(tmp_path_factory):
    """The one-thread P12 and team P12 at each of ``VARIANTS``, g++ builds,
    with each team body's stats."""
    _gxx()
    out = tmp_path_factory.mktemp("soa_team")
    bodies = {v: P.soa_substep_team_body(P.ROUNDS, *v) for v in VARIANTS}
    libs = build.build_in_parallel(
        lambda: build.host_library(build.PROBE_SOA, P.soa_substep_body(P.ROUNDS), out),
        *[(lambda v=v: build.host_library(build.PROBE_SOA_TEAM, bodies[v][0], out))
          for v in VARIANTS])
    return dict(one=libs[0], team=dict(zip(VARIANTS, libs[1:])),
                stats={v: b[1] for v, b in bodies.items()})


def _run(fn, q, v):
    got = torch.full_like(q, float("nan"))
    assert fn(q.data_ptr(), v.data_ptr(), got.data_ptr(), q.shape[1]) == 0
    return got


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
@pytest.mark.parametrize("B", [37, 64])
def test_team_soa_bit_for_bit(soa_libs, variant, B):
    """Team P12 equals the one-thread P12 and the program on the host's math
    bit for bit, and the plain version within rtol 1e-6."""
    q, v = P.soa_inputs(B, seed=B, device="cpu")
    got = _run(soa_libs["team"][variant].probe_soa_team_host, q, v)
    one = _run(soa_libs["one"].probe_soa_host, q, v)
    assert common.compare_exact([got], [one]) == (0.0, 0)
    host_math = SimpleNamespace(rsqrt=lambda x: 1 / _exact_sqrt(x), cos=_libm("cosf"),
                                sin=_libm("sinf"), abs=torch.abs)
    want = torch.stack(P.substep_program(q.unbind(0), v.unbind(0), P.ROUNDS, host_math))
    assert common.compare_exact([got], [want]) == (0.0, 0)
    torch.testing.assert_close(got, P.soa_substep_rows(q, v), rtol=CPU_MATH_RTOL, atol=0)


def test_team_soa_matches_the_tpu_kernel_body(soa_libs, monkeypatch):
    """Team P12 (the probe's schedule) against ``substep_like_kernel`` on
    ``jnp`` arrays through stand-in refs at one TPU tile (1024 envs): atol
    1e-6, rtol 1e-5 (XLA's rsqrt, cos and sin on the CPU are not the
    host's)."""
    dev = _dev("pallas_soa_probe", monkeypatch)
    q, v = P.soa_inputs(dev.TILE_B, seed=7, device="cpu")

    class Out:
        def __init__(self):
            self.rows = {}

        def __setitem__(self, i, x):
            self.rows[i] = np.asarray(x)

    out = Out()
    dev.substep_like_kernel(jnp.asarray(q.numpy()), jnp.asarray(v.numpy()), out)
    want = np.stack([out.rows[i] for i in range(P.NQ)])
    got = _run(soa_libs["team"][VARIANTS[0]].probe_soa_team_host, q, v).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_team_soa_streams_in_lockstep(soa_libs, variant):
    """The W streams run in lockstep: every value computed once, in one
    stream (nothing is replicated: the program has no loop); every
    cross-warp read after its write and a barrier; the same barrier count
    in every stream; the streams' operations sum to the one-thread body's
    ``cgen.op_count``, which is the build record's ``ops_per_env``. The
    split schedule puts less than 70 % of the work on one warp; the probe's
    schedule passes 5 barriers."""
    warps, cap = variant
    prog = P.soa_substep_program(P.ROUNDS)
    sch = team.Schedule(prog, warps, cap, 0.0)  # soa_substep_team_body's crossing cost
    streams = team.render_streams(sch)
    barriers, computed, runs = _lockstep(streams, prog, sch)
    assert set(computed) == set(runs)
    assert all(len(by) == 1 and list(by.values()) == [runs[name]]
               for name, by in computed.items())
    stats = soa_libs["stats"][variant]
    assert barriers == stats["barriers"] > 0
    assert all(team.stream_barriers(x) == barriers for x in streams)
    ops = [team.stream_ops(x) for x in streams]
    assert ops == stats["stream_ops"] and stats["replicated_ops"] == 0
    assert sum(ops) == stats["ops_per_env"] == cgen.op_count(P.soa_substep_body(P.ROUNDS))
    if cap == 16:
        assert max(ops) < stats["ops_per_env"] * 0.7
    else:
        assert barriers == 5
    assert stats["warps"] == warps and stats["shared_bytes"] <= team.SHARED_BUDGET


def test_team_soa_wrapper_names_and_records():
    """The team wrapper on CPU tensors runs the plain version and refuses
    bad warps; launch names and build records keep the designs, round
    counts and warps apart."""
    q, v = P.soa_inputs(40, seed=2, device="cpu")
    out = torch.empty_like(q)
    P.soa_substep(q, v, out, team=True)
    assert torch.equal(out, P.soa_substep_rows(q, v))
    for bad in (dict(warps=0), dict(warps=33)):
        with pytest.raises(ValueError, match="warps"):
            P.soa_substep(q, v, out, team=True, **bad)
    with pytest.raises(ValueError, match="buffer"):
        P.soa_substep(q, v, q, team=True)
    with pytest.raises(ValueError, match="unsupported device"):
        P.soa_substep(q.to("meta"), v.to("meta"), out.to("meta"), team=True)
    assert P.soa_name(team=True) == "soa_substep_team"
    assert P.record(team=True) == "probe_soa_team[60 rounds]"
    assert P.record(240, True, 8) == "probe_soa_team[240 rounds, 8 warps]"
    names = {P.soa_name(r, t, w) for r in (60, 240) for t in (False, True)
             for w in (8, P.TEAM_WARPS)}
    records = {P.record(r, t, w) for r in (60, 240) for t in (False, True)
               for w in (8, P.TEAM_WARPS)}
    assert len(names) == len(records) == 2 * (1 + 2)


@pytest.fixture(scope="module")
def chain_libs(tmp_path_factory):
    _gxx()
    out = tmp_path_factory.mktemp("chain")
    return build.build_in_parallel(lambda: build.host_library(build.FMA_CHAIN, "", out),
                                   lambda: build.host_library(build.FMA_CHAIN_ILP, "", out))


@pytest.mark.parametrize("blocks, n", [(7, 100), (5, 33), (24, 40)])
@pytest.mark.parametrize("mode", F.MODES)
def test_chain_redesign_bit_for_bit(chain_libs, mode, blocks, n):
    """The redesign's g++ build (8 elements per thread over 96 threads)
    equals ``chain_rows`` and the one-element kernel's g++ build bit for
    bit, on ragged grids (7 x 100: a short last group of blocks and several
    strided passes, the last one short; 5 x 33: fewer blocks than a group)
    and on a whole one (24 x 40: three full groups, one pass, idle
    threads); it refuses a bad mode."""
    one, ilp = chain_libs
    a, b = F.chain_inputs(n, "cpu")
    a = a + torch.arange(n, dtype=torch.float32) * 1e-7
    want = F.chain_rows(a, b, 24, mode, blocks)
    got = torch.full((blocks, n), float("nan"))
    assert ilp.fma_chain_ilp_host(a.data_ptr(), b.data_ptr(), got.data_ptr(), n, 24,
                                  F.MODES.index(mode), blocks) == 0
    ref = torch.empty((blocks, n))
    assert one.fma_chain_host(a.data_ptr(), b.data_ptr(), ref.data_ptr(), n, 24,
                              F.MODES.index(mode), blocks) == 0
    assert torch.equal(got, want) and torch.equal(ref, want)
    assert ilp.fma_chain_ilp_host(a.data_ptr(), b.data_ptr(), got.data_ptr(), n, 24, 3,
                                  blocks) != 0


def test_chain_plain_matches_the_tpu_probe_chains(monkeypatch):
    """``chain_rows`` against ``dev/probe_fma_fusion.py``'s chains on the
    TPU probe's tile values at K = 8, run eagerly in JAX (each operation
    rounded, as the plain loop rounds it): bit for bit, every block's seed
    ``a + g * 1e-9``."""
    dev = _dev("probe_fma_fusion", monkeypatch, ["probe_fma_fusion.py", "8"])
    assert dev.K == 8
    a, b = F.chain_inputs(128, "cpu")
    for mode, chain in zip(F.MODES, (dev.muladd_chain, dev.add_chain, dev.mul_chain)):
        want = F.chain_rows(a, b, 8, mode, 3)
        for g in range(3):
            seeded = jnp.asarray(a.numpy()) + jnp.float32(g) * 1e-9
            got = np.asarray(chain(seeded, jnp.asarray(b.numpy())))
            np.testing.assert_array_equal(got, want[g].numpy(), err_msg=f"{mode} block {g}")


SASS = """
        code for sm_90a
                Function : _Z20fma_chain_ilp_kernelPKfS0_Pfiiii
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   MOV R4, RZ ;                            /* 0x000000ff00047202 */
.L_x_1:
        /*0020*/                   FFMA R2, R2, R3.reuse, R5.reuse ;       /* 0x0000000302027223 */
        /*0030*/                   FFMA R6, R6, R3, R5 ;                   /* 0x0000000706067223 */
        /*0040*/                   IADD3 R4, R4, 0x1, RZ ;                 /* 0x0000000104047810 */
        /*0050*/                   ISETP.GE.AND P0, PT, R4, R9, PT ;       /* 0x000000090400720c */
        /*0060*/               @!P0 BRA `(.L_x_1) ;                        /* 0xfffffffc00e08947 */
        /*0070*/                   FMUL R2, R2, 2 ;                        /* 0x4000000002027820 */
        /*0080*/                   EXIT ;                                  /* 0x000000000000794d */
                Function : _Z16fma_chain_kernelPKfS0_Pfiii
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   FADD R2, R2, R3 ;                       /* 0x0000000302027221 */
        /*0010*/                   FADD R2, R2, R3 ;                       /* 0x0000000302027221 */
        /*0020*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;       /* 0x000000ff0400720c */
        /*0030*/                @P0 BRA 0x0 ;                              /* 0xfffffffc00e00947 */
        /*0040*/                   BRA 0x50 ;                              /* 0x0000000000007947 */
        /*0050*/                   EXIT ;                                  /* 0x000000000000794d */
"""


def test_sass_reader_counts_functions_and_loops(monkeypatch):
    """The SASS reader splits a listing by kernel function, counts each
    function's FFMA / FMUL / FADD, and finds each loop (a branch back to an
    earlier instruction, by label or by address) with its instruction mix,
    its FP32 operand reads (the second FFMA takes R3 and R5 from the reuse
    cache; the first reads two odd registers from the file) and whether it
    is innermost; a forward branch is no loop."""
    funcs = common.sass_functions(SASS)
    assert [len(f["instrs"]) for f in funcs.values()] == [9, 6]
    loops = common.sass_loops(SASS, "fma_chain_ilp_kernel")
    assert loops == [dict(function="_Z20fma_chain_ilp_kernelPKfS0_Pfiiii",
                          instructions=5, fp32={"FFMA": 2},
                          other={"BRA": 1, "IADD3": 1, "ISETP": 1},
                          reads=dict(three_register=2, reused=2, bank_conflicts=1), inner=True)]
    old = common.sass_loops(SASS, "fma_chain_kernel")
    assert [(x["instructions"], x["fp32"], x["inner"]) for x in old] == [(4, {"FADD": 2}, True)]
    monkeypatch.setattr(common, "sass_text", lambda record, kernel: SASS)
    assert common.sass_counts("r", build.FMA_CHAIN) == {"FFMA": 2, "FMUL": 1, "FADD": 2}
    assert common.fp32_counts(SASS, "fma_chain_kernel") == {"FFMA": 0, "FMUL": 0, "FADD": 2}


NESTED = """
                Function : _Z16fma_chain_kernelPKfS0_Pfiii
.L_x_0:
        /*0000*/                   FFMA R8, R8, R9, R10 ;
.L_x_1:
        /*0010*/                   FMUL R2, R2, R3 ;
        /*0020*/                   FADD R2, R2, R4 ;
        /*0030*/               @!P0 BRA `(.L_x_1) ;
        /*0040*/                   FFMA R2, R2, R3, R4 ;
        /*0050*/               @!P1 BRA `(.L_x_0) ;
        /*0060*/                   EXIT ;
"""


def test_sass_loops_nesting_and_contraction():
    """An outer loop around an inner one is not innermost. A build
    contracts every pair when an innermost FP32 loop holds FFMA and none
    holds FMUL and FADD together (``contracts_every_pair``): the redesign's
    outer grid-stride loop may hold both (its add2k and mul2k remainders)
    without an uncontracted pair; no SASS is no evidence."""
    loops = common.sass_loops(NESTED, "fma_chain_kernel")
    assert [(x["instructions"], x["fp32"], x["inner"]) for x in loops] == [
        (3, {"FMUL": 1, "FADD": 1}, True), (6, {"FFMA": 2, "FMUL": 1, "FADD": 1}, False)]

    def report(*fp32_inner):
        return dict(loops=[dict(fp32=f, inner=inner) for f, inner in fp32_inner])

    assert not F.contracts_every_pair(dict(loops=loops))
    assert F.contracts_every_pair(report(({"FFMA": 128}, True), ({"FMUL": 128}, True),
                                         ({"FADD": 128}, True),
                                         ({"FFMA": 8, "FMUL": 248, "FADD": 248}, False)))
    assert not F.contracts_every_pair(report(({"FFMA": 64, "FMUL": 64, "FADD": 64}, True)))
    assert not F.contracts_every_pair(report(({"FMUL": 4}, True), ({"FADD": 4}, True)))
    assert not F.contracts_every_pair(None)


def test_issue_floors():
    """The chain's floors on the TPU's grid at 1980 MHz (``clocks.max.sm``
    of an H100 SXM) and 132 SMs: 4000 FFMA per element 62.7 us, 8000
    FMUL / FADD 125.4 us; the flop bound (a multiply-add counts 2) over 67
    TFLOP/s 62.6 us."""
    elements = F.TPU_GRID[0] * F.TPU_GRID[1]
    K = F.K_DEFAULT
    assert F.fp32_instructions(K, "muladd", True) == K
    assert F.fp32_instructions(K, "muladd", False) == F.fp32_instructions(K, "add2k", True) == \
        2 * K
    assert F.issue_floor_us(K, elements, 132, 1980.0) == pytest.approx(62.7, abs=0.05)
    assert F.issue_floor_us(2 * K, elements, 132, 1980.0) == pytest.approx(125.4, abs=0.05)
    assert 2 * K * elements / 67e12 * 1e6 == pytest.approx(62.6, abs=0.05)


def test_chain_wrappers_names_and_records():
    """Both chain wrappers run the plain version on CPU tensors and refuse
    bad inputs; the two designs' launch names and build records, and team
    K1's ``--fmad=true`` build and launch name, are their own."""
    a, b = F.chain_inputs(16, "cpu")
    for wrapper in (F.fma_chain, F.fma_chain_one_element):
        out = torch.empty(3, 16)
        wrapper(a, b, out, 5, "mul2k", 3, True)
        assert torch.equal(out, F.chain_rows(a, b, 5, "mul2k", 3))
        with pytest.raises(ValueError):
            wrapper(a, b, torch.empty(2, 16), 5, "mul2k", 3, False)
        with pytest.raises(ValueError, match="mode"):
            wrapper(a, b, out, 5, "fma", 3, False)
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(a.to("meta"), b.to("meta"), out.to("meta"), 5, "add2k", 3, False)
    names = {F.chain_name(f, o) for f in (False, True) for o in (False, True)}
    assert names == {"fma_chain", "fma_chain_fmad", "fma_chain[one-element]",
                     "fma_chain_fmad[one-element]"}
    fmad = build.probe_flags(True)
    records = {build.record_name(k, "", build.probe_flags(f))
               for k in (build.FMA_CHAIN, build.FMA_CHAIN_ILP) for f in (False, True)}
    records |= {build.record_name(build.PROBE_PHYSICS_TEAM, "full", build.probe_flags(f))
                for f in (False, True)}
    records |= {build.record_name(build.PROBE_SOA_TEAM, "60 rounds"),
                build.record_name(build.PROBE_SOA, "60 rounds")}
    assert len(records) == 8
    assert build.record_name(build.PROBE_PHYSICS_TEAM, "full", fmad) == \
        "probe_physics_team[full][--fmad=true]"
    assert build.record_name(build.FMA_CHAIN_ILP, "", fmad) == "fma_chain_ilp[--fmad=true]"
    assert common.k1_probe_name(None, fmad=True, team=True) == "k1_team_probe_full_fmad"


def test_team_k1_fmad_wrapper_on_the_cpu():
    """``physics_probe_team(..., fmad=True)`` on CPU tensors runs the plain
    version, as the ``--fmad=false`` call does."""
    env = H.torch_env()
    s, B = env._s, 40
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.to_torch(H.physics_step_blocks(env.model, dr, np.random.RandomState(3), n=B))
    outs = {f: common.empty_outputs(s, B, "cpu") for f in (False, True)}
    for f in (False, True):
        common.physics_probe_team(s, 1, blocks, outs[f], fmad=f)
    assert all(torch.equal(x, y) for x, y in zip(outs[False], outs[True]))


_RENDER = """
import hashlib, sys
sys.path.insert(0, {tests!r})
import torch_port_helpers as H
from puppax_torch.kernels import team
source, stats = team.physics_step_team_body(H.torch_env()._s, 1, 4)
print(hashlib.sha256(source.encode()).hexdigest(), stats["replicated_ops"])
"""


def test_team_body_text_does_not_depend_on_the_hash_seed():
    """Team K1's body at 1 substep on 4 warps (the line search's loops run
    whole in every warp: a replicated loop whose free names are a set)
    renders byte-identical text in two processes under PYTHONHASHSEED 0
    and 1, so the build cache keyed by its sha256 hits across processes."""
    out = []
    for seed in ("0", "1"):
        proc = subprocess.run(
            [sys.executable, "-c", _RENDER.format(tests=str(REPO / "tests"))],
            capture_output=True, text=True, timeout=600, cwd=REPO,
            env=dict(os.environ, PYTHONHASHSEED=seed))
        assert proc.returncode == 0, proc.stderr[-2000:]
        out.append(proc.stdout.split())
    assert out[0] == out[1] and int(out[0][1]) > 0


@pytest.mark.parametrize("argv", [["--team", "--warps", "2,4,6,8"],
                                  ["--rounds", "60", "--team"]])
def test_soa_team_cli_needs_a_card(argv):
    with pytest.raises(SystemExit) as e:
        P.main(argv)
    assert "no CUDA device found" in str(e.value)


def test_fma_cli_needs_a_card():
    proc = subprocess.run([sys.executable, "-m", "puppax_torch.probes.probe_fma_fusion",
                           "--K", "64"], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no CUDA device found" in proc.stderr
    assert "us per launch" not in proc.stdout
    with pytest.raises(SystemExit):
        F.main(["--elements", "8"])
