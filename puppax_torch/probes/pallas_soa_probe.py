"""Is a large straight-line per-env body viable on the card? A synthetic SoA substep.

    python -m puppax_torch.probes.pallas_soa_probe [--rounds 60,240,960] [--envs 4096]

The H100 counterpart of ``dev/pallas_soa_probe.py`` (``soa_substep`` :103,
``pallas_call`` :106), which approximated one physics substep's op mix on
``(8, 128)`` tiles and asked what a large unrolled batch-on-lanes kernel
costs to compile and to run at B = 4096. Its kernel (``substep_like_kernel``,
:55-97), one env at a time: normalize the base quaternion with ``rsqrt``; 12
hinge chains of ``cos`` / ``sin``, a quaternion product and a rotation each;
``rounds`` (60) rounds of an 18-term dot product, each followed by 18
updates; a triangular chain of 18 ``rsqrt(|a| + 1)``; an integrate-like
output of 19 rows.

Here ``substep_program`` states that program once, on rows of any type
that has ``+ - *``; ``soa_substep_rows`` (the plain version) runs it as
torch ops on ``(19, B)`` / ``(18, B)`` blocks, and ``soa_substep_body``
runs it on ``kernels/cgen.py``'s ``CProgram`` and emits one SSA statement
per operation in the same order: the body of ``csrc/probe_soa.cuh`` (one
thread per env, 128 per block), straight-line as K1-K4 are, counted by
``cgen.op_count``. Every literal is the float32 rounding of the Python
value, computed in double first (``0.01 * (i + r % 7)``), as JAX's weak
typing rounds it; ``rsqrt`` is ``1 / sqrt`` on both sides; ``0 * acc[2]``
stays a multiply; ``0.001 * s * q`` is ``(0.001 * s) * q``. With
``--fmad=false`` the kernel equals the plain version bit for bit (the
card's ``cosf`` / ``sinf`` are torch's CUDA ``cos`` / ``sin``), and
``check`` holds it so.

Inputs are standard normals from ``numpy.random.default_rng(seed)``: q
``(19, B)``, then v ``(18, B)``. The TPU probe drew them with
``jax.random.normal(PRNGKey(0))``, which the port cannot reproduce until
its threefry port, so the values differ; the program does not.

Timing, as the TPU probe timed it (:131-146): 100 chained substeps, ``q <-
soa_substep(q, v)``, carried between two preallocated buffer sets,
eagerly and replayed from one CUDA graph (the device's time), best of 5
windows. For each ``rounds`` it prints us per substep, the build's
generated lines, float operations per env, nvcc seconds, registers, stack
and spill bytes, and the ns per operation of one env's body (all envs in
parallel); larger bodies (``--rounds``; 960 rounds is about K3's operation
count) chart nvcc time and throughput against the size of the body.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Dict, Sequence

import numpy as np
import torch

from puppax_torch.kernels import build, cgen
from puppax_torch.probes import common

NQ, NV = 19, 18
ROUNDS = 60  # dev/pallas_soa_probe.py:77
B_DEFAULT = 4096  # dev/pallas_soa_probe.py:20
CHAIN = 100  # chained substeps per timed window (dev/pallas_soa_probe.py:134)
RUNS = 5  # timed windows (dev/pallas_soa_probe.py:142)
CLI_ROUNDS = (60, 240, 960)


def _f32(x: float) -> float:
    """A Python value rounded once to float32, as JAX's weak typing rounds
    a Python scalar against a float32 array."""
    return float(np.float32(x))


def _qmul(a, b):
    """Quaternion product on component tuples (dev/pallas_soa_probe.py:25-34)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _rot(v, q):
    """Rotate the vector tuple v by the quaternion tuple q (:37-52)."""
    w, x, y, z = q
    vx, vy, vz = v
    uv = x * vx + y * vy + z * vz
    uu = x * x + y * y + z * z
    s = w
    cx = y * vz - z * vy
    cy = z * vx - x * vz
    cz = x * vy - y * vx
    k = s * s - uu
    return (
        2 * uv * x + k * vx + 2 * s * cx,
        2 * uv * y + k * vy + 2 * s * cy,
        2 * uv * z + k * vz + 2 * s * cz,
    )


def substep_program(q: Sequence, v: Sequence, rounds: int, m) -> list:
    """``substep_like_kernel`` (dev/pallas_soa_probe.py:55-97) on the 19 q and
    18 v rows, in its order of operations; ``m`` gives ``rsqrt``, ``cos``,
    ``sin`` and ``abs``. Returns the 19 output rows."""
    n = m.rsqrt(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] + q[6] * q[6])
    base_q = (q[3] * n, q[4] * n, q[5] * n, q[6] * n)
    acc = [q[0], q[1], q[2]]
    quats = []
    for i in range(12):
        half = 0.5 * q[7 + i]
        c, s = m.cos(half), m.sin(half)
        qloc = (c, s * _f32(0.1), s * _f32(0.2), s * _f32(0.97))
        bq = _qmul(base_q if i < 4 else quats[i - 4], qloc)
        quats.append(bq)
        p = _rot((acc[0] * _f32(0.01), acc[1] * _f32(0.02), _f32(0.03) + 0 * acc[2]), bq)
        acc = [acc[0] + p[0], acc[1] + p[1], acc[2] + p[2]]
    outv = list(v)
    for r in range(rounds):
        s = 0.0
        for i in range(18):
            s = s + outv[i] * _f32(0.01 * (i + r % 7))
        for i in range(18):
            outv[i] = outv[i] + _f32(0.001) * s * quats[i % 12][r % 4]
    cols = []
    for k in range(18):
        a = outv[k]
        for j in range(len(cols)):
            a = a - cols[j] * cols[j] * _f32(0.01)
        cols.append(m.rsqrt(m.abs(a) + 1.0))
    out = [q[i] + _f32(0.004) * outv[i] + _f32(0.0001) * acc[i] for i in range(3)]
    out += list(base_q)
    out += [q[7 + i] + _f32(0.004) * outv[6 + i] + _f32(0.0001) * cols[i] for i in range(12)]
    return out


_TORCH_MATH = SimpleNamespace(rsqrt=lambda x: 1 / torch.sqrt(x), cos=torch.cos, sin=torch.sin,
                              abs=torch.abs)


def soa_substep_rows(q: torch.Tensor, v: torch.Tensor, rounds: int = ROUNDS) -> torch.Tensor:
    """The plain version: ``substep_program`` as torch ops on q ``(19, B)``
    and v ``(18, B)``; returns the ``(19, B)`` output."""
    return torch.stack(substep_program(q.unbind(0), v.unbind(0), rounds, _TORCH_MATH))


def soa_substep_body(rounds: int = ROUNDS) -> str:
    """C source of ``soa_substep_body`` (``csrc/probe_soa.cuh``'s body):
    ``substep_program`` emitted as one SSA statement per operation, row r of
    env b at ``ptr[r * B + b]``."""
    prog = cgen.CProgram()
    q = [prog.load("q", r) for r in range(NQ)]
    v = [prog.load("v", r) for r in range(NV)]
    math_ = SimpleNamespace(**{f: (lambda x, f=f: prog.unary(f, x))
                               for f in ("rsqrt", "cos", "sin", "abs")})
    for r, x in enumerate(substep_program(q, v, rounds, math_)):
        prog.store("q_out", r, x)
    header = (
        "// Generated by puppax_torch/probes/pallas_soa_probe.py from the synthetic\n"
        f"// SoA substep at {rounds} rounds, {prog.count} values. Do not edit.\n"
        "PUPPAX_HD inline void soa_substep_body(SOA_PARAMS, int B, int b) {\n"
    )
    return header + "\n".join(prog.lines) + "\n}\n"


def library(rounds: int = ROUNDS):
    """The kernel of ``rounds`` rounds, built at first use
    (``build.probe_soa_library`` around ``soa_substep_body(rounds)``)."""
    return build.probe_soa_library(rounds, lambda: soa_substep_body(rounds))


def soa_name(rounds: int = ROUNDS) -> str:
    """The launch name of one build: ``soa_substep``, with the round count
    where it is not the TPU probe's 60."""
    return "soa_substep" if rounds == ROUNDS else f"soa_substep_{rounds}_rounds"


def record(rounds: int = ROUNDS) -> str:
    """The build's ``build.last_build`` record."""
    return build.record_name(build.PROBE_SOA, f"{int(rounds)} rounds")


def soa_substep(q: torch.Tensor, v: torch.Tensor, out: torch.Tensor, rounds: int = ROUNDS):
    """One substep of q ``(19, B)`` and v ``(18, B)`` into the preallocated
    ``out`` ``(19, B)`` (another buffer than q's), every block contiguous
    float32 on one device. CPU tensors run the plain version
    (``soa_substep_rows``); CUDA tensors launch the kernel of
    ``csrc/probe_soa.cuh`` on the current stream, or raise. Each launch
    counts in ``common.launches[soa_name(rounds)]``."""
    B, dev = build.check_blocks((NQ, NV, NQ), (q, v, out))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"soa_substep: unsupported device {dev}")
    if out.data_ptr() in (q.data_ptr(), v.data_ptr()):
        raise ValueError("soa_substep: out must not be q's or v's buffer")
    if dev.type == "cpu":
        out.copy_(soa_substep_rows(q, v, rounds))
        return
    lib = library(rounds)
    build.launch_into("probe_soa", lib.probe_soa_launch, [q, v, out], B)
    common.count_launch(soa_name(rounds))


def soa_inputs(B: int, seed: int, device):
    """q ``(19, B)`` then v ``(18, B)``, standard normals from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((NQ, B)).astype(np.float32)
    v = rng.standard_normal((NV, B)).astype(np.float32)
    return torch.from_numpy(q).to(device), torch.from_numpy(v).to(device)


def check(q: torch.Tensor, v: torch.Tensor, rounds: int = ROUNDS) -> Dict[str, object]:
    """One ``soa_substep`` launch held bit for bit against
    ``soa_substep_rows`` on the same blocks; raises if an env differs or the
    plain version is not finite. Returns ``max_abs_err``, ``differing`` envs
    and the plain version's ``plain_ms``."""
    got = torch.empty_like(q)
    soa_substep(q, v, got, rounds)
    want = []
    plain_ms = common.window_ms(lambda: want.append(soa_substep_rows(q, v, rounds)))
    err, differing = common.compare_exact([got], [want[0]])
    if differing or not bool(torch.isfinite(want[0]).all()):
        raise AssertionError(f"{soa_name(rounds)}: {differing} of {q.shape[1]} envs differ "
                             f"from the plain version, or it is not finite")
    return dict(max_abs_err=err, differing=differing, plain_ms=plain_ms)


def run(device, rounds_list: Sequence[int] = (ROUNDS,), B: int = B_DEFAULT, seed: int = 0,
        check_envs: Sequence[int] = (B_DEFAULT, common.TILE), chain: int = CHAIN,
        runs: int = RUNS) -> Dict[int, dict]:
    """For each round count (built before, ``library``): the
    kernel held against the plain version at each of ``check_envs`` (the
    first envs of the inputs), then ``chain`` chained substeps at ``B`` envs
    timed. Returns, per round count: ``checks`` (envs -> ``check``'s
    dict), ``eager_us`` and ``graph_us`` per substep, ``plain_ms`` at B,
    ``envs``, ``lines``, ``ops_per_env``, ``nvcc_s``, ptxas's
    ``registers``, ``stack``, ``spill_stores``, ``spill_loads``, and
    ``ns_per_op`` (the graphed time over one env's operations)."""
    q, v = soa_inputs(B, seed, device)
    print(common.nvidia_smi(), flush=True)
    print(f"synthetic SoA substep at {B} envs: {chain} chained substeps per window (q carried), "
          f"best of {runs} windows (CUDA events), eager and from one CUDA graph:", flush=True)
    results = {}
    for rounds in rounds_list:
        name = soa_name(rounds)
        checks = {}
        for n in check_envs:
            checks[n] = check(q[:, :n].contiguous(), v[:, :n].contiguous(), rounds)
            print(f"soa_substep vs plain ({rounds} rounds) at {n} envs: max abs err "
                  f"{checks[n]['max_abs_err']!r}, {checks[n]['differing']} envs differ",
                  flush=True)
        carry = common.Carry(lambda a, b: soa_substep(a, v, b, rounds), (q,), chain)
        carry.reset()
        carry.window()
        if not bool(torch.isfinite(carry.sets[chain % 2][0]).all()):
            raise AssertionError(f"{name}: {chain} chained substeps are not finite")
        eager, graph = common.eager_and_graph_ms(carry.window, runs, carry.reset)
        plain = []
        plain_ms = common.window_ms(lambda: plain.append(soa_substep_rows(q, v, rounds)))
        info = build.last_build[record(rounds)]
        res = dict(checks=checks, eager_us=eager * 1e3 / chain, graph_us=graph * 1e3 / chain,
                   plain_ms=plain_ms, envs=B, lines=info["lines"], ops_per_env=info["ops_per_env"],
                   nvcc_s=info["compile_seconds"], **common.ptxas_info(record(rounds)))
        res["ns_per_op"] = res["graph_us"] * 1e3 / res["ops_per_env"]
        results[rounds] = res
        print(f"{name:28s} {rounds:4d} rounds: {res['lines']} lines, {res['ops_per_env']} ops per "
              f"env, nvcc {res['nvcc_s']:.1f} s, {res['registers']} registers, stack "
              f"{res['stack']} B, spills {res['spill_stores']} / {res['spill_loads']} B; eager "
              f"{res['eager_us']:9.3f} us, graph {res['graph_us']:9.3f} us per substep, "
              f"{res['ns_per_op']:.4f} ns per env-op; plain {plain_ms:.3f} ms", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", default=",".join(map(str, CLI_ROUNDS)),
                    help="comma-separated round counts, one build each")
    ap.add_argument("--envs", type=int, default=B_DEFAULT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rounds_list = [int(r) for r in args.rounds.split(",")]
    common.require_cuda("pallas_soa_probe")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    build.build_in_parallel(*[(lambda r=r: library(r)) for r in rounds_list])
    common.print_builds([record(r) for r in rounds_list])
    results = run(device, rounds_list, args.envs, args.seed,
                  check_envs=(args.envs, min(args.envs, common.TILE)))
    if len(rounds_list) > 1:
        print("nvcc seconds and graphed us per substep against the body's size:", flush=True)
        for r, res in results.items():
            print(f"  {r:4d} rounds: {res['lines']:6d} lines, {res['ops_per_env']:6d} ops, nvcc "
                  f"{res['nvcc_s']:6.1f} s, {res['registers']} registers, spills "
                  f"{res['spill_stores']} B, {res['graph_us']:9.3f} us, {res['ns_per_op']:.4f} ns "
                  f"per env-op", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
