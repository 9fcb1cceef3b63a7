"""The Newton step's linear solve alone: a batched 18 x 18 SPD solve, one warp per env.

    python -m puppax_torch.probes.pallas_spd_poc [B] [--warps 4,8,16,32]

The H100 counterpart of ``dev/pallas_spd_poc.py`` (``pallas_spd_solve`` :57,
``pallas_call`` :61), which solved A x = b for B symmetric positive-definite
18 x 18 systems with the env batch on the lanes (A ``(18, 18, B)``, b
``(18, B)``) and compared it with the batch-first ``jax.vmap`` of
``puppax/ops/linalg.py::spd_solve``, the solve of the physics solver's
Newton step and of the mass matrix.

- The kernel (``csrc/probe_spd_warp.cuh``, ``spd_solve``): the left-looking
  Cholesky, the forward and the back substitution of ``linalg.spd_solve``,
  one warp per env, lane i owning row i; a block of ``SPD_WARPS`` warps
  stages its 32 envs' rows in shared memory.
- The one-thread kernel (``csrc/probe_spd.cuh``, ``spd_solve_one_thread``,
  launch name ``spd_solve[one-thread]``): one thread per env, the factor's
  171 entries in registers; the A/B.
- The plain version (``spd_solve_rows``): the port's own
  ``puppax_torch.ops.linalg.spd_solve`` on the batch-first view of the same
  blocks, the counterpart of the TPU probe's ``jax.vmap(linalg.spd_solve)``
  (:89). On the card both kernels equal it bit for bit.
- The library yardsticks: the one-call ``torch.linalg.solve_ex`` (an LU
  solve, the kernels line's ``library_ms``), and ``torch.linalg.cholesky_ex``
  with ``torch.cholesky_solve`` on ``(B, 18, 18)`` (``library_solve``; on
  the card through cuSOLVER, ``cusolver_backend``), held within
  ``LIBRARY_TOL`` of ``max|x|`` (the TPU probe's check, :92). Nothing in
  the port calls them.

Inputs are the TPU probe's own (:76-80): ``numpy.random.default_rng(0)``,
M standard normal ``(B, 18, 18)``, A = M M^T + 3 I, b standard normal
``(B, 18)``. Each case is timed as the TPU probe's ``ITERS = 50`` solves
per window, eagerly and replayed from one CUDA graph (the device's time),
best of 3 windows; the two kernels in turns (one-thread, warp, warp,
one-thread; the better of each pair) at 4096 and 128 envs, each other W of
``--warps`` once beside them.
"""

from __future__ import annotations

import argparse
import contextlib
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from puppax_torch.kernels import build
from puppax_torch.ops import linalg
from puppax_torch.probes import common

N = 18  # dev/pallas_spd_poc.py:24
B_DEFAULT = 4096  # dev/pallas_spd_poc.py:72
ITERS = 50  # solves per timed window (dev/pallas_spd_poc.py:98)
LIBRARY_TOL = 1e-4  # of max|x| (dev/pallas_spd_poc.py:92)
# the warps per block of the warp kernel (csrc/probe_spd_warp.cuh takes 4, 8,
# 16 or 32; chosen on the card from the CLI's sweep, PERF.md)
WARPS = (4, 8, 16, 32)
SPD_WARPS = 32


def spd_op_count(n: int = N) -> int:
    """Float operations of one env's solve in the kernel: the Cholesky's
    multiply-subtract pairs, each pivot's max and sqrt, each column's
    divisions, and the two substitutions (a multiply-subtract pair per
    off-diagonal entry, a division per row)."""
    cholesky = sum(2 * k * (n - k) + 2 + (n - k) for k in range(n))
    return cholesky + 2 * (n * (n - 1) + n)


def spd_rows(n: int = N):
    """(rows read, rows written) per env: the triangle of A on and below the
    diagonal (neither kernel loads another element of A) and b; x."""
    return n * (n + 1) // 2 + n, n


def spd_inputs(B: int, seed: int = 0):
    """The TPU probe's systems as numpy arrays: A ``(B, 18, 18)``, b ``(B, 18)``."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, N)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + 3.0 * np.eye(N, dtype=np.float32)
    b = rng.standard_normal((B, N)).astype(np.float32)
    return A, b


def to_lanes(A: torch.Tensor, b: torch.Tensor):
    """Batch-first A ``(B, 18, 18)`` and b ``(B, 18)`` as the kernel's
    contiguous ``(18, 18, B)`` and ``(18, B)`` blocks."""
    return A.permute(1, 2, 0).contiguous(), b.t().contiguous()


def _check(A_t: torch.Tensor, b_t: torch.Tensor, x: Optional[torch.Tensor] = None) -> int:
    B = b_t.shape[-1] if b_t.ndim == 2 else -1
    blocks = (("A", A_t, (N, N, B)), ("b", b_t, (N, B)))
    for name, t, shape in blocks + ((("x", x, (N, B)),) if x is not None else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"spd_solve: {name} has dtype {t.dtype}, expected float32")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"spd_solve: {name} is {tuple(t.shape)}, expected a contiguous "
                             f"{shape}")
        if t.device != b_t.device:
            raise ValueError(f"spd_solve: {name} on {t.device}, b on {b_t.device}")
    return B


def spd_solve_rows(A_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The plain version: ``linalg.spd_solve`` on the batch-first view of A
    ``(18, 18, B)`` and b ``(18, B)``; returns x ``(18, B)``."""
    _check(A_t, b_t)
    return linalg.spd_solve(A_t.permute(2, 0, 1), b_t.t()).t().contiguous()


def _solve(A_t, b_t, x, one_thread: bool, warps: int):
    B = _check(A_t, b_t, x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spd_solve: unsupported device {x.device}")
    if x.data_ptr() in (A_t.data_ptr(), b_t.data_ptr()):
        raise ValueError("spd_solve: x must not be A's or b's buffer")
    if warps not in WARPS:
        raise ValueError(f"spd_solve: {warps} warps per block is not one of {WARPS}")
    if x.device.type == "cpu":
        x.copy_(spd_solve_rows(A_t, b_t))
        return
    if one_thread:
        lib = build.probe_spd_library()
        build.launch_into("probe_spd", lib.probe_spd_launch, [A_t, b_t, x], B)
        common.count_launch("spd_solve[one-thread]")
    else:
        lib = build.probe_spd_warp_library()
        build.launch_into("probe_spd_warp", lib.probe_spd_warp_launch, [A_t, b_t, x], B, warps)
        common.count_launch("spd_solve")


def spd_solve(A_t: torch.Tensor, b_t: torch.Tensor, x: torch.Tensor, warps: int = SPD_WARPS):
    """Solve A x = b for every env into the preallocated ``x`` ``(18, B)``
    (A ``(18, 18, B)``, b ``(18, B)``, each contiguous float32 on one
    device). CPU tensors run the plain version (``spd_solve_rows``); CUDA
    tensors launch the one-warp-per-env kernel of ``csrc/probe_spd_warp.cuh``
    (``warps`` warps per block, one of ``WARPS``) on the current stream, or
    raise. Each launch counts in ``common.launches["spd_solve"]``."""
    _solve(A_t, b_t, x, False, warps)


def spd_solve_one_thread(A_t: torch.Tensor, b_t: torch.Tensor, x: torch.Tensor):
    """``spd_solve`` through the one-thread kernel of ``csrc/probe_spd.cuh``
    (one env per thread, 128 threads per block): the A/B. Each launch counts
    in ``common.launches["spd_solve[one-thread]"]``."""
    _solve(A_t, b_t, x, True, SPD_WARPS)


def library_solve(A: torch.Tensor, b: torch.Tensor):
    """``torch.linalg.cholesky_ex`` then ``torch.cholesky_solve`` on
    batch-first A ``(B, 18, 18)`` and b ``(B, 18)``. Returns x ``(B, 18)``
    and ``info`` (nonzero where a factorization failed; the caller looks,
    which waits for the card)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0], info


def check(A_t: torch.Tensor, b_t: torch.Tensor, warps: int = SPD_WARPS) -> Dict[str, object]:
    """One ``spd_solve`` launch and one ``spd_solve_one_thread`` launch, each
    held bit for bit against ``spd_solve_rows`` on the same blocks; raises
    if an env differs. Returns ``max_abs_err`` and ``differing`` envs of the
    warp kernel, ``one_thread`` (the same of the one-thread kernel) and the
    plain version's ``plain_ms``."""
    want = []
    plain_ms = common.window_ms(lambda: want.append(spd_solve_rows(A_t, b_t)))
    out = {}
    for name, solve in (("one_thread", spd_solve_one_thread),
                        ("warp", lambda A, b, x: spd_solve(A, b, x, warps))):
        got = torch.empty_like(b_t)
        solve(A_t, b_t, got)
        err, differing = common.compare_exact([got], [want[0]])
        if differing or not bool(torch.isfinite(want[0]).all()):
            raise AssertionError(f"spd_solve ({name}): {differing} of {b_t.shape[1]} envs differ "
                                 "from the plain version, or it is not finite")
        out[name] = dict(max_abs_err=err, differing=differing)
    return dict(out["warp"], one_thread=out["one_thread"], plain_ms=plain_ms)


@contextlib.contextmanager
def cusolver_backend():
    """torch.linalg on the card through cuSOLVER inside the block: by
    default a batched ``cholesky_solve`` goes to MAGMA, whose calls cannot
    be captured in a CUDA graph."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def library_us(fn, iters: int = ITERS, runs: int = common.RUNS):
    """(eager, graph) microseconds per call of ``fn`` (a kernel or a library
    yardstick), ``iters`` calls per window; raises where its calls cannot be
    captured in a CUDA graph."""
    def window():
        for _ in range(iters):
            fn()

    eager, graph = common.eager_and_graph_ms(window, runs)
    return eager * 1e3 / iters, graph * 1e3 / iters


# the SASS mnemonics the CLI counts per W: the work, the shuffles, the
# special-function unit, branches and reconvergence, shared and global memory
SASS_MIX = ("FMUL", "FADD", "FFMA", "MUFU", "SHFL", "BRA", "BSSY", "BSYNC", "CALL", "LDS",
            "STS", "LDG", "STG")


def warp_ptxas(sass: bool = False) -> Dict[int, dict]:
    """ptxas's numbers (``common.ptxas_functions``) of the warp kernel at
    each W, from its build's log; with ``sass``, under ``sass`` the SASS
    instruction counts of its function (``SASS_MIX`` and ``total``; None
    where the toolkit has no cuobjdump)."""
    record = build.record_name(build.PROBE_SPD_WARP)
    with open(f"{build.last_build[record]['dir']}/build.log") as f:
        funcs = common.ptxas_functions(f.read())
    text = common.sass_text(record, build.PROBE_SPD_WARP) if sass else None
    out = {}
    for name, info in funcs.items():
        m = re.search(r"probe_spd_warp_kernelILi(\d+)E", name)
        if m:
            out[int(m.group(1))] = dict(info, sass=None if text is None else
                                        common.mnemonic_counts(text, SASS_MIX, name))
    return out


def run(device, B: int = B_DEFAULT, seed: int = 0,
        check_envs: Sequence[int] = (B_DEFAULT, common.TILE),
        time_envs: Sequence[int] = (B_DEFAULT, common.TILE), warps: Sequence[int] = (SPD_WARPS,),
        iters: int = ITERS, runs: int = common.RUNS, sass: bool = False) -> Dict[str, object]:
    """The TPU probe's systems at ``B`` envs: both kernels held against the
    plain version at each of ``check_envs`` (the first envs), the library
    pair against the warp kernel, then ``iters`` solves per window timed at
    B and each of ``time_envs``: the one-thread and the warp kernel (``SPD_WARPS``)
    in turns, each other W of ``warps`` once; the yardsticks at ``B``.
    Returns ``checks`` (envs -> ``check``'s dict), ``library_rel_err`` (the
    pair's max abs difference from the kernel over ``max|x|``), ``times``
    (envs -> {"one_thread": (eager, graph) us, "warp": {W: (eager, graph)
    us}}), ``eager_us`` / ``graph_us`` and ``one_thread_us`` (eager, graph)
    per solve at ``B``, ``cusolver_us`` and ``solve_ex_us`` (eager, graph),
    ``plain_ms``, ``envs``, ``ops_per_env``, ``nvcc_s`` and the one-thread
    build's ``nvcc_one_thread_s``, ``ptxas`` (W -> the warp kernel's
    registers, stack, spills and static shared bytes, and with ``sass`` its
    SASS instruction counts) and ``one_thread`` (the one-thread kernel's)."""
    A_np, b_np = spd_inputs(B, seed)
    A, b = torch.from_numpy(A_np).to(device), torch.from_numpy(b_np).to(device)
    A_t, b_t = to_lanes(A, b)
    print(common.nvidia_smi(), flush=True)
    checks = {}
    for n in check_envs:
        checks[n] = check(A_t[..., :n].contiguous(), b_t[:, :n].contiguous())
        print(f"spd_solve vs plain at {n} envs: max abs err {checks[n]['max_abs_err']!r}, "
              f"{checks[n]['differing']} envs differ; spd_solve[one-thread]: "
              f"{checks[n]['one_thread']['differing']} envs differ", flush=True)
    for w in warps:
        if w != SPD_WARPS:
            x_w = torch.empty_like(b_t)
            spd_solve(A_t, b_t, x_w, w)
            if common.compare_exact([x_w], [spd_solve_rows(A_t, b_t)])[1]:
                raise AssertionError(f"spd_solve at {w} warps differs from the plain version")
    x = torch.empty_like(b_t)
    spd_solve(A_t, b_t, x)
    with cusolver_backend():
        lib_x, info = library_solve(A, b)
    if bool(info.any()):
        raise AssertionError(f"cholesky_ex failed on {int((info != 0).sum())} systems")
    scale = float(x.abs().max())
    rel = float((lib_x.t() - x).abs().max()) / scale
    print(f"spd_solve vs cholesky_ex+cholesky_solve (cuSOLVER) at {B} envs: max abs diff "
          f"{rel * scale:.3e}, {rel:.3e} of max|x| {scale:.3f} (limit {LIBRARY_TOL})", flush=True)
    if not rel < LIBRARY_TOL:
        raise AssertionError(f"spd_solve: the library pair is {rel:.3e} of max|x| away")
    ptxas = warp_ptxas(sass)
    for w in sorted(ptxas):
        if ptxas[w]["sass"] is not None:
            print(f"spd_solve at {w:2d} warps: SASS {ptxas[w]['sass']}", flush=True)
    one_record = build.record_name(build.PROBE_SPD)
    print(f"batched {N} x {N} SPD solve, {iters} solves per window, best of {runs} windows (CUDA "
          "events), eager and from one CUDA graph; the one-thread and the warp kernel "
          f"({SPD_WARPS} warps) in turns (one-thread, warp, warp, one-thread):", flush=True)

    def us(pair):
        return f"eager {pair[0]:9.3f} us, graph {pair[1]:9.3f} us"

    times = {}
    for n in dict.fromkeys((B, *time_envs)):
        A_n, b_n = A_t[..., :n].contiguous(), b_t[:, :n].contiguous()
        x_n = torch.empty_like(b_n)

        def timed(solve):
            return library_us(lambda: solve(A_n, b_n, x_n), iters, runs)

        turns = [timed(s) for s in (spd_solve_one_thread, spd_solve, spd_solve,
                                    spd_solve_one_thread)]
        one = tuple(min(a, b) for a, b in zip(turns[0], turns[3]))
        by_w = {SPD_WARPS: tuple(min(a, b) for a, b in zip(turns[1], turns[2]))}
        for w in warps:
            if w != SPD_WARPS:
                by_w[w] = timed(lambda A_, b_, x_, w=w: spd_solve(A_, b_, x_, w))
        times[n] = dict(one_thread=one, warp=by_w)
        print(f"{n:5d} envs  spd_solve[one-thread]  {us(one)} per solve", flush=True)
        for w in sorted(by_w):
            p = ptxas[w]
            print(f"{n:5d} envs  spd_solve {w:2d} warps    {us(by_w[w])} per solve "
                  f"({one[1] / by_w[w][1]:.2f}x the one-thread kernel); {p['registers']} "
                  f"registers, {p['smem']} B shared, stack {p['stack']} B, spills "
                  f"{p['spill_stores']} / {p['spill_loads']} B", flush=True)
    with cusolver_backend():
        cusolver_us = library_us(lambda: library_solve(A, b), iters, runs)
        solve_ex_us = library_us(lambda: torch.linalg.solve_ex(A, b), iters, runs)
    plain = []
    plain_ms = common.window_ms(lambda: plain.append(spd_solve_rows(A_t, b_t)))
    warp_at_b = times[B]["warp"][SPD_WARPS]
    res = dict(checks=checks, library_rel_err=rel, times=times, eager_us=warp_at_b[0],
               graph_us=warp_at_b[1], one_thread_us=times[B]["one_thread"],
               cusolver_us=cusolver_us, solve_ex_us=solve_ex_us, plain_ms=plain_ms, envs=B,
               ops_per_env=spd_op_count(),
               nvcc_s=build.last_build[build.record_name(build.PROBE_SPD_WARP)]["compile_seconds"],
               nvcc_one_thread_s=build.last_build[one_record]["compile_seconds"], ptxas=ptxas,
               one_thread=common.ptxas_info(one_record))
    p = res["one_thread"]
    print(f"spd_solve[one-thread]: {p['registers']} registers, stack {p['stack']} B, spills "
          f"{p['spill_stores']} / {p['spill_loads']} B, nvcc {res['nvcc_one_thread_s']:.1f} s; "
          f"spd_solve (warp): nvcc {res['nvcc_s']:.1f} s", flush=True)
    print(f"{B:5d} envs  cholesky_ex + cholesky_solve  {us(res['cusolver_us'])} per solve",
          flush=True)
    print(f"{B:5d} envs  torch.linalg.solve_ex (LU)    {us(res['solve_ex_us'])} per solve",
          flush=True)
    print(f"plain version (linalg.spd_solve) {plain_ms:.3f} ms", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=B_DEFAULT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warps", type=lambda t: tuple(int(x) for x in t.split(",")), default=WARPS,
                    help="the warps per block to time the warp kernel at")
    args = ap.parse_args(argv)
    common.require_cuda("pallas_spd_poc")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    build.build_in_parallel(build.probe_spd_library, build.probe_spd_warp_library)
    common.print_builds([build.record_name(build.PROBE_SPD),
                         build.record_name(build.PROBE_SPD_WARP)])
    small = min(args.B, common.TILE)
    run(device, args.B, args.seed, check_envs=(args.B, small), time_envs=(args.B, small),
        warps=args.warps, sass=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
