"""The Newton step's linear solve alone: a batched 18 x 18 SPD solve, one thread per env.

    python -m puppax_torch.probes.pallas_spd_poc [B]

The H100 counterpart of ``dev/pallas_spd_poc.py`` (``pallas_spd_solve`` :57,
``pallas_call`` :61), which solved A x = b for B symmetric positive-definite
18 x 18 systems with the env batch on the lanes (A ``(18, 18, B)``, b
``(18, B)``) and compared it with the batch-first ``jax.vmap`` of
``puppax/ops/linalg.py::spd_solve``, the solve of the physics solver's
Newton step and of the mass matrix.

- The kernel (``csrc/probe_spd.cuh``, ``spd_solve``): the left-looking
  Cholesky, the forward and the back substitution of ``linalg.spd_solve``,
  one thread per env (128 per block), the factor's 171 entries in
  registers, only the rows on and below each pivot computed.
- The plain version (``spd_solve_rows``): the port's own
  ``puppax_torch.ops.linalg.spd_solve`` on the batch-first view of the same
  blocks, the counterpart of the TPU probe's ``jax.vmap(linalg.spd_solve)``
  (:89). On the card the kernel equals it bit for bit.
- The library twin (``library_solve``): ``torch.linalg.cholesky_ex`` and
  ``torch.cholesky_solve`` on ``(B, 18, 18)`` (on the card through
  cuSOLVER, ``cusolver_backend``), held
  within ``LIBRARY_TOL`` of ``max|x|`` (the TPU probe's check, :92), and
  the one-call ``torch.linalg.solve_ex`` (an LU solve), timed beside. They
  are yardsticks: nothing in the port calls them.

Inputs are the TPU probe's own (:76-80): ``numpy.random.default_rng(0)``,
M standard normal ``(B, 18, 18)``, A = M M^T + 3 I, b standard normal
``(B, 18)``. Each case is timed as the TPU probe's ``ITERS = 50`` solves
per window, eagerly and replayed from one CUDA graph (the device's time),
best of 3 windows.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from puppax_torch.kernels import build
from puppax_torch.ops import linalg
from puppax_torch.probes import common

N = 18  # dev/pallas_spd_poc.py:24
B_DEFAULT = 4096  # dev/pallas_spd_poc.py:72
ITERS = 50  # solves per timed window (dev/pallas_spd_poc.py:98)
LIBRARY_TOL = 1e-4  # of max|x| (dev/pallas_spd_poc.py:92)


def spd_op_count(n: int = N) -> int:
    """Float operations of one env's solve in the kernel: the Cholesky's
    multiply-subtract pairs, each pivot's max and sqrt, each column's
    divisions, and the two substitutions (a multiply-subtract pair per
    off-diagonal entry, a division per row)."""
    cholesky = sum(2 * k * (n - k) + 2 + (n - k) for k in range(n))
    return cholesky + 2 * (n * (n - 1) + n)


def spd_rows(n: int = N):
    """(rows read, rows written) per env: the triangle of A on and below the
    diagonal (the kernel loads no other element of A) and b; x."""
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


def spd_solve(A_t: torch.Tensor, b_t: torch.Tensor, x: torch.Tensor):
    """Solve A x = b for every env into the preallocated ``x`` ``(18, B)``
    (A ``(18, 18, B)``, b ``(18, B)``, each contiguous float32 on one
    device). CPU tensors run the plain version (``spd_solve_rows``); CUDA
    tensors launch the kernel of ``csrc/probe_spd.cuh`` on the current
    stream, or raise. Each launch counts in ``common.launches["spd_solve"]``."""
    B = _check(A_t, b_t, x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spd_solve: unsupported device {x.device}")
    if x.data_ptr() in (A_t.data_ptr(), b_t.data_ptr()):
        raise ValueError("spd_solve: x must not be A's or b's buffer")
    if x.device.type == "cpu":
        x.copy_(spd_solve_rows(A_t, b_t))
        return
    lib = build.probe_spd_library()
    build.launch_into("probe_spd", lib.probe_spd_launch, [A_t, b_t, x], B)
    common.count_launch("spd_solve")


def library_solve(A: torch.Tensor, b: torch.Tensor):
    """``torch.linalg.cholesky_ex`` then ``torch.cholesky_solve`` on
    batch-first A ``(B, 18, 18)`` and b ``(B, 18)``. Returns x ``(B, 18)``
    and ``info`` (nonzero where a factorization failed; the caller looks,
    which waits for the card)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0], info


def check(A_t: torch.Tensor, b_t: torch.Tensor) -> Dict[str, object]:
    """One ``spd_solve`` launch held bit for bit against ``spd_solve_rows`` on
    the same blocks; raises if an env differs. Returns ``max_abs_err``,
    ``differing`` envs and the plain version's ``plain_ms``."""
    got = torch.empty_like(b_t)
    spd_solve(A_t, b_t, got)
    want = []
    plain_ms = common.window_ms(lambda: want.append(spd_solve_rows(A_t, b_t)))
    err, differing = common.compare_exact([got], [want[0]])
    if differing or not bool(torch.isfinite(want[0]).all()):
        raise AssertionError(f"spd_solve: {differing} of {b_t.shape[1]} envs differ from the "
                             f"plain version, or it is not finite")
    return dict(max_abs_err=err, differing=differing, plain_ms=plain_ms)


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
    """(eager, graph) microseconds per call of a library yardstick ``fn``,
    ``iters`` calls per window; raises where its calls cannot be captured in
    a CUDA graph."""
    def window():
        for _ in range(iters):
            fn()

    eager, graph = common.eager_and_graph_ms(window, runs)
    return eager * 1e3 / iters, graph * 1e3 / iters


def run(device, B: int = B_DEFAULT, seed: int = 0, check_envs=(B_DEFAULT, common.TILE),
        iters: int = ITERS, runs: int = common.RUNS) -> Dict[str, object]:
    """The TPU probe's systems at ``B`` envs: the kernel held against the
    plain version at each of ``check_envs`` (the first envs), the library
    pair against the kernel, then ``iters`` solves per window timed.
    Returns ``checks`` (envs -> ``check``'s dict), ``library_rel_err`` (the
    pair's max abs difference from the kernel over ``max|x|``),
    ``eager_us`` / ``graph_us`` per solve of the kernel, ``cusolver_us``
    and ``solve_ex_us`` (eager, graph), ``plain_ms``, ``envs``, ``ops_per_env``, ``nvcc_s`` and
    ptxas's ``registers``, ``stack``, ``spill_stores``, ``spill_loads``."""
    A_np, b_np = spd_inputs(B, seed)
    A, b = torch.from_numpy(A_np).to(device), torch.from_numpy(b_np).to(device)
    A_t, b_t = to_lanes(A, b)
    print(common.nvidia_smi(), flush=True)
    checks = {}
    for n in check_envs:
        checks[n] = check(A_t[..., :n].contiguous(), b_t[:, :n].contiguous())
        print(f"spd_solve vs plain at {n} envs: max abs err {checks[n]['max_abs_err']!r}, "
              f"{checks[n]['differing']} envs differ", flush=True)
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
    print(f"batched {N} x {N} SPD solve at {B} envs, {iters} solves per window, best of {runs} "
          f"windows (CUDA events), eager and from one CUDA graph:", flush=True)

    def kernel_window():
        for _ in range(iters):
            spd_solve(A_t, b_t, x)

    eager, graph = common.eager_and_graph_ms(kernel_window, runs)
    with cusolver_backend():
        cusolver_us = library_us(lambda: library_solve(A, b), iters, runs)
        solve_ex_us = library_us(lambda: torch.linalg.solve_ex(A, b), iters, runs)
    plain = []
    plain_ms = common.window_ms(lambda: plain.append(spd_solve_rows(A_t, b_t)))
    record = build.record_name(build.PROBE_SPD)
    res = dict(checks=checks, library_rel_err=rel, eager_us=eager * 1e3 / iters,
               graph_us=graph * 1e3 / iters, cusolver_us=cusolver_us,
               solve_ex_us=solve_ex_us, plain_ms=plain_ms, envs=B,
               ops_per_env=spd_op_count(), nvcc_s=build.last_build[record]["compile_seconds"],
               **common.ptxas_info(record))

    def us(pair):
        return f"eager {pair[0]:9.3f} us, graph {pair[1]:9.3f} us"

    print(f"spd_solve (kernel)               {us((res['eager_us'], res['graph_us']))} per solve; "
          f"{res['registers']} registers, stack {res['stack']} B, spills "
          f"{res['spill_stores']} / {res['spill_loads']} B, nvcc {res['nvcc_s']:.1f} s", flush=True)
    print(f"cholesky_ex + cholesky_solve     {us(res['cusolver_us'])} per solve", flush=True)
    print(f"torch.linalg.solve_ex (LU)       {us(res['solve_ex_us'])} per solve", flush=True)
    print(f"plain version (linalg.spd_solve) {plain_ms:.3f} ms", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=B_DEFAULT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    common.require_cuda("pallas_spd_poc")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    build.probe_spd_library()
    common.print_builds([build.record_name(build.PROBE_SPD)])
    run(device, args.B, args.seed, check_envs=(args.B, min(args.B, common.TILE)))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
