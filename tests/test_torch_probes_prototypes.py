"""Probe group C (``pallas_soa_probe``, ``pallas_spd_poc``) on the CPU.

- ``csrc/probe_soa.cuh`` around the emitted body (60 rounds),
  ``csrc/probe_spd.cuh`` and the solve's one-warp-per-env redesign
  ``csrc/probe_spd_warp.cuh`` (its warp emulated on the host, a loop over
  the lanes per step), built with g++, against their programs bit for
  bit where the math functions are the same on both sides: the host's
  correctly rounded sqrt and libm's ``cosf`` / ``sinf``. torch's CPU
  ``sqrt`` (vectorized) is not correctly rounded and its ``cos`` / ``sin``
  part from libm's in the last bit, so the plain versions as they are are
  held within ``rtol 1e-6`` (a few ulp; the card's sqrt, cos and sin are
  the CUDA math library's on both sides, where ``tests/test_torch_cuda.py``
  holds them bit for bit).
- The plain versions against the TPU kernels: ``soa_substep_rows`` against
  ``dev/pallas_soa_probe.py::substep_like_kernel`` run eagerly on ``jnp``
  arrays through stand-in refs (Pallas interpret mode takes minutes at
  this size), and ``spd_solve_rows`` against
  ``dev/pallas_spd_poc.py::pallas_spd_solve(..., interpret=True)`` and
  ``jax.vmap(puppax.ops.linalg.spd_solve)``; both dev modules are loaded
  from their paths, which runs nothing.
- The body's operation count per round, its literals, the solve's count,
  the library pair on the CPU, the wrappers' checks and
  both command lines without a card.
"""

import ctypes
import ctypes.util
import importlib.util
import os
import re
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puppax.ops import linalg as jlinalg
from puppax_torch.kernels import build, cgen
from puppax_torch.probes import common, pallas_soa_probe, pallas_spd_poc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = (pallas_soa_probe, pallas_spd_poc)
# torch's vectorized CPU sqrt is not correctly rounded and its cos / sin part
# from libm's in the last bit: the plain versions as they are, against the
# g++ builds (on the card both sides use the CUDA math library, bit for bit)
CPU_MATH_RTOL = 1e-6


def _dev(name: str):
    spec = importlib.util.spec_from_file_location(f"dev_{name}",
                                                  os.path.join(REPO, "dev", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exact_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt rounded once to float32 (through float64, where sqrt is exact
    enough that the double rounding is harmless), as C's ``sqrtf``."""
    return torch.sqrt(x.double()).to(x.dtype)


def _libm(name: str):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lambda x: torch.tensor([fn(a) for a in x.tolist()], dtype=torch.float32)


@pytest.fixture(scope="module")
def soa_host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probe's C cannot be built on the host")
    body = pallas_soa_probe.soa_substep_body(pallas_soa_probe.ROUNDS)
    return build.host_library(build.PROBE_SOA, body, tmp_path_factory.mktemp("soa"))


@pytest.fixture(scope="module")
def spd_host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probe's C cannot be built on the host")
    return build.host_library(build.PROBE_SPD, "", tmp_path_factory.mktemp("spd"))


@pytest.fixture(scope="module")
def spd_warp_host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probe's C cannot be built on the host")
    return build.host_library(build.PROBE_SPD_WARP, "", tmp_path_factory.mktemp("spd_warp"))


def _spd_blocks(B: int, seed: int = 0):
    A, b = pallas_spd_poc.spd_inputs(B, seed)
    return pallas_spd_poc.to_lanes(torch.from_numpy(A), torch.from_numpy(b))


def test_soa_host_build_is_bit_for_bit(soa_host):
    """The g++-built substep (60 rounds) equals ``substep_program`` with the
    host's math functions bit for bit at 256 envs; the plain version and
    the CPU wrapper as they are stay within rtol 1e-6 of it."""
    q, v = pallas_soa_probe.soa_inputs(256, seed=0, device="cpu")
    got = torch.empty_like(q)
    assert soa_host.probe_soa_host(q.data_ptr(), v.data_ptr(), got.data_ptr(), 256) == 0
    host_math = SimpleNamespace(rsqrt=lambda x: 1 / _exact_sqrt(x), cos=_libm("cosf"),
                                sin=_libm("sinf"), abs=torch.abs)
    want = torch.stack(pallas_soa_probe.substep_program(q.unbind(0), v.unbind(0),
                                                        pallas_soa_probe.ROUNDS, host_math))
    assert common.compare_exact([got], [want]) == (0.0, 0)
    plain = pallas_soa_probe.soa_substep_rows(q, v)
    wrapped = torch.empty_like(q)
    pallas_soa_probe.soa_substep(q, v, wrapped)
    assert torch.equal(wrapped, plain) and torch.isfinite(plain).all()
    torch.testing.assert_close(got, plain, rtol=CPU_MATH_RTOL, atol=0)
    assert soa_host.probe_soa_host(q.data_ptr(), v.data_ptr(), got.data_ptr(), -1) != 0


@pytest.mark.parametrize("B", [256, 200])
def test_spd_host_build_is_bit_for_bit(spd_host, monkeypatch, B):
    """The g++-built solve equals ``spd_solve_rows`` with a correctly rounded
    sqrt bit for bit (also at a B that is no multiple of 128); the plain
    version as it is stays within 1e-6 of max|x|, and the CPU wrapper
    equals it."""
    A_t, b_t = _spd_blocks(B, seed=1)
    got = torch.empty_like(b_t)
    assert spd_host.probe_spd_host(A_t.data_ptr(), b_t.data_ptr(), got.data_ptr(), B) == 0
    plain = pallas_spd_poc.spd_solve_rows(A_t, b_t)
    wrapped = torch.empty_like(b_t)
    pallas_spd_poc.spd_solve(A_t, b_t, wrapped)
    assert torch.equal(wrapped, plain)
    assert float((got - plain).abs().max()) <= CPU_MATH_RTOL * float(plain.abs().max())
    real_sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: real_sqrt(x.double()).to(x.dtype))
    exact = pallas_spd_poc.spd_solve_rows(A_t, b_t)
    assert common.compare_exact([got], [exact]) == (0.0, 0)


@pytest.mark.parametrize("B", [256, 200, 130])
def test_spd_warp_host_build_is_bit_for_bit(spd_host, spd_warp_host, monkeypatch, B):
    """The g++ build of the one-warp-per-env solve (each step a loop over the
    lanes, each shuffle a read of the source lane) equals the one-thread
    g++ build and ``spd_solve_rows`` with a correctly rounded sqrt bit for
    bit, on whole 32-env blocks and ragged ones, at every W the launch
    takes; another W is refused."""
    A_t, b_t = _spd_blocks(B, seed=7)
    one = torch.empty_like(b_t)
    assert spd_host.probe_spd_host(A_t.data_ptr(), b_t.data_ptr(), one.data_ptr(), B) == 0
    for warps in pallas_spd_poc.WARPS:
        got = torch.full_like(b_t, float("nan"))
        assert spd_warp_host.probe_spd_warp_host(A_t.data_ptr(), b_t.data_ptr(), got.data_ptr(),
                                                 B, warps) == 0
        assert common.compare_exact([got], [one]) == (0.0, 0)
    real_sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: real_sqrt(x.double()).to(x.dtype))
    exact = pallas_spd_poc.spd_solve_rows(A_t, b_t)
    assert common.compare_exact([got], [exact]) == (0.0, 0)
    assert spd_warp_host.probe_spd_warp_host(A_t.data_ptr(), b_t.data_ptr(), got.data_ptr(), B,
                                             5) != 0


def test_spd_warp_ptxas_per_function():
    """``common.ptxas_functions`` splits a build log by entry function: the
    warp kernel's registers and shared bytes at each W."""
    log = ("ptxas info    : Compiling entry function '_Z21probe_spd_warp_kernelILi4EEvPKfS1_Pfii'"
           " for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 1 barriers, 24192 bytes smem\n"
           "ptxas info    : Compiling entry function '_Z21probe_spd_warp_kernelILi32EEvPKfS1_Pfii'"
           " for 'sm_90a'\n    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers, 24192 bytes smem\n")
    funcs = common.ptxas_functions(log)
    assert funcs["_Z21probe_spd_warp_kernelILi4EEvPKfS1_Pfii"] == dict(
        registers=40, stack=0, spill_stores=0, spill_loads=0, smem=24192)
    assert funcs["_Z21probe_spd_warp_kernelILi32EEvPKfS1_Pfii"]["spill_stores"] == 4


def test_plain_soa_matches_the_tpu_kernel_body():
    """``soa_substep_rows`` against the TPU kernel's body
    (``substep_like_kernel``) on ``jnp`` arrays through stand-in refs, at
    1024 envs (one TPU tile): atol 1e-6, rtol 1e-5 (XLA's rsqrt, cos and
    sin on the CPU are not torch's)."""
    dev = _dev("pallas_soa_probe")
    q, v = pallas_soa_probe.soa_inputs(dev.TILE_B, seed=3, device="cpu")

    class Out:
        def __init__(self):
            self.rows = {}

        def __setitem__(self, i, x):
            self.rows[i] = np.asarray(x)

    out = Out()
    dev.substep_like_kernel(jnp.asarray(q.numpy()), jnp.asarray(v.numpy()), out)
    want = np.stack([out.rows[i] for i in range(pallas_soa_probe.NQ)])
    got = pallas_soa_probe.soa_substep_rows(q, v).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_plain_spd_matches_the_tpu_kernel_and_vmap():
    """``spd_solve_rows`` against the TPU kernel in interpret mode and
    against ``jax.vmap(linalg.spd_solve)`` at 256 envs (one TPU tile),
    within 1e-5 of max|x|."""
    dev = _dev("pallas_spd_poc")
    A, b = pallas_spd_poc.spd_inputs(dev.TILE, seed=0)
    A_t, b_t = pallas_spd_poc.to_lanes(torch.from_numpy(A), torch.from_numpy(b))
    got = pallas_spd_poc.spd_solve_rows(A_t, b_t).numpy()
    tpu = np.asarray(dev.pallas_spd_solve(jnp.asarray(A_t.numpy()), jnp.asarray(b_t.numpy()),
                                          interpret=True))
    vmap = np.asarray(jax.jit(jax.vmap(jlinalg.spd_solve))(jnp.asarray(A), jnp.asarray(b))).T
    scale = float(np.abs(got).max())
    for name, want in (("pallas interpret", tpu), ("vmap", vmap)):
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, name


def test_soa_body_counts_rounds_and_literals():
    """One round is 18 multiply-adds of the dot product and 18 updates of
    three operations: 90 counted operations; each body is straight-line
    (no loop), and every float literal carries its f."""
    bodies = {r: pallas_soa_probe.soa_substep_body(r) for r in (0, 2, 60)}
    ops = {r: cgen.op_count(body) for r, body in bodies.items()}
    assert ops[60] - ops[0] == 60 * 90 and ops[2] - ops[0] == 2 * 90
    body = bodies[60]
    assert "for (" not in body and "60 rounds" in body.splitlines()[1]
    assert body.count("q_out[") == pallas_soa_probe.NQ and "cosf(" in body and "sinf(" in body
    literals = re.findall(r"(?<![\w.])\d+\.\d*(?:e[+-]?\d+)?f?", body)
    assert literals and all(x.endswith("f") for x in literals)
    assert "0.009999999776482582f" in body  # 0.01 rounded once to float32
    assert pallas_soa_probe.record(60) == "probe_soa[60 rounds]"
    assert [pallas_soa_probe.soa_name(r) for r in (60, 960)] == ["soa_substep",
                                                                 "soa_substep_960_rounds"]


def test_spd_op_count_and_library_pair_on_cpu():
    """The solve's count by hand at n = 2 and the 18 x 18 total; the library
    pair (``cholesky_ex`` + ``cholesky_solve``) agrees with the plain
    version within the TPU probe's 1e-4 of max|x| and flags a matrix that
    is not positive definite in ``info``."""
    assert pallas_spd_poc.spd_op_count(2) == 17 and pallas_spd_poc.spd_op_count() == 2793
    A, b = (torch.from_numpy(x) for x in pallas_spd_poc.spd_inputs(64, seed=2))
    x, info = pallas_spd_poc.library_solve(A, b)
    want = pallas_spd_poc.spd_solve_rows(*pallas_spd_poc.to_lanes(A, b)).t()
    assert not info.any()
    assert float((x - want).abs().max()) < pallas_spd_poc.LIBRARY_TOL * float(want.abs().max())
    bad = A.clone()
    bad[5] = -torch.eye(pallas_spd_poc.N)
    assert pallas_spd_poc.library_solve(bad, b)[1].nonzero().flatten().tolist() == [5]


def test_soa_wrapper_refuses_bad_inputs():
    q, v = pallas_soa_probe.soa_inputs(256, seed=4, device="cpu")
    out = torch.empty_like(q)
    with pytest.raises(TypeError):
        pallas_soa_probe.soa_substep(q.double(), v, out)
    with pytest.raises(ValueError):  # v of another B
        pallas_soa_probe.soa_substep(q, v[:, :128].contiguous(), out)
    with pytest.raises(ValueError):  # q as (B, 19)
        pallas_soa_probe.soa_substep(q.t().contiguous(), v, out)
    with pytest.raises(ValueError):  # not contiguous
        pallas_soa_probe.soa_substep(q, v, torch.empty(256, 19).t())
    with pytest.raises(ValueError, match="buffer"):
        pallas_soa_probe.soa_substep(q, v, q)
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_soa_probe.soa_substep(q.to("meta"), v.to("meta"), out.to("meta"))


def test_spd_wrapper_refuses_bad_inputs():
    A_t, b_t = _spd_blocks(256, seed=5)
    x = torch.empty_like(b_t)
    with pytest.raises(TypeError):
        pallas_spd_poc.spd_solve(A_t.double(), b_t, x)
    with pytest.raises(ValueError):  # A of another B
        pallas_spd_poc.spd_solve(A_t[..., :128].contiguous(), b_t, x)
    with pytest.raises(ValueError):  # not contiguous
        pallas_spd_poc.spd_solve(A_t.transpose(0, 1), b_t, x)
    with pytest.raises(ValueError):  # x of 17 rows
        pallas_spd_poc.spd_solve(A_t, b_t, torch.empty(17, 256))
    with pytest.raises(ValueError, match="buffer"):
        pallas_spd_poc.spd_solve(A_t, b_t, b_t)
    with pytest.raises(ValueError):  # b on another device than A
        pallas_spd_poc.spd_solve(A_t.to("meta"), b_t, x)
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_spd_poc.spd_solve(A_t.to("meta"), b_t.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="warps"):  # the kernel takes 4, 8, 16 or 32
        pallas_spd_poc.spd_solve(A_t, b_t, x, warps=6)
    with pytest.raises(ValueError, match="buffer"):  # the one-thread A/B checks alike
        pallas_spd_poc.spd_solve_one_thread(A_t, b_t, b_t)
    pallas_spd_poc.spd_solve_one_thread(A_t, b_t, x)
    assert torch.equal(x, pallas_spd_poc.spd_solve_rows(A_t, b_t))
    assert build.record_name(build.PROBE_SPD) == "probe_spd"
    assert build.record_name(build.PROBE_SPD_WARP) == "probe_spd_warp"


@pytest.mark.parametrize("probe", PROBES, ids=[p.__name__.rsplit(".", 1)[1] for p in PROBES])
def test_probe_cli_needs_a_card(probe):
    with pytest.raises(SystemExit) as e:
        probe.main([])
    assert "no CUDA device found" in str(e.value)
