"""Is a large straight-line per-env body viable on the card? A synthetic SoA substep.

    python -m puppax_torch.probes.pallas_soa_probe [--rounds 60,240,960] [--envs 4096]
        [--team] [--warps 2,4,6,8]

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

The team design (``soa_substep(..., team=True)``, ``csrc/probe_soa_team.cuh``)
runs the same ``CProgram`` split across the W warps of a 32-env block by
``kernels/team.py`` (``soa_substep_team_body``), as the production kernels
K1-K4 run theirs: one thread per env leaves 4096 envs on one warp per SM,
one of its four schedulers. It was tried on the H100 and not adopted: it is
slower than the one-thread kernel at every W and stage budget measured
(PERF.md section 6), so the one-thread kernel stays P12's kernel and the
team kernel its A/B. A small stage budget splits each round's products and
updates across the warps at the price of a barrier per stage (16 at W = 4:
a heaviest stream of 2,903 of 6,715 operations, 271 barriers); each
barrier cost more than the split gained, and the least slow schedule has
no budget (``TEAM_CAP`` is larger than the program): the rounds' dependent
chain on one warp, the hinge chains beside it, 5 barriers. Every operation
is the one-thread program's, so the team kernel equals the one-thread
kernel and the plain version bit for bit; ``check`` holds it against both.

Inputs are standard normals from ``numpy.random.default_rng(seed)``: q
``(19, B)``, then v ``(18, B)``. The TPU probe drew them with
``jax.random.normal(PRNGKey(0))``, which the port cannot reproduce until
its threefry port, so the values differ; the program does not.

Timing, as the TPU probe timed it (:131-146): 100 chained substeps, ``q <-
soa_substep(q, v)``, carried between two preallocated buffer sets,
eagerly and replayed from one CUDA graph (the device's time), best of 5
windows, the designs in turns (one-thread, each team build, the team
builds again, one-thread; the median of each design's two). For each
``rounds`` it prints us per substep, the build's generated lines, float
operations per env, nvcc seconds, registers, stack and spill bytes, and the
ns per operation of one env's body (all envs in parallel); each team
build adds its heaviest stream, barriers, shared bytes and ns per
heaviest-stream operation. Larger bodies (``--rounds``; 960 rounds is about
K3's operation count) chart nvcc time and throughput against the size of
the body; ``--team --warps`` sweeps the team's warps beside the one-thread
body.
"""

from __future__ import annotations

import argparse
import statistics
from types import SimpleNamespace
from typing import Dict, Sequence

import numpy as np
import torch

from puppax_torch.kernels import build, cgen
from puppax_torch.kernels.team import team_body
from puppax_torch.probes import common

NQ, NV = 19, 18
ROUNDS = 60  # dev/pallas_soa_probe.py:77
B_DEFAULT = 4096  # dev/pallas_soa_probe.py:20
CHAIN = 100  # chained substeps per timed window (dev/pallas_soa_probe.py:134)
RUNS = 5  # timed windows (dev/pallas_soa_probe.py:142)
CLI_ROUNDS = (60, 240, 960)
# the team design: warps per block and the schedule's stage budget (no
# budget: larger than the program), the least slow of the card's sweep (W =
# 2, 4, 8 x budget 8-100000; PERF.md)
TEAM_WARPS = 2
TEAM_CAP = 100000
CLI_WARPS = (2, 4, 6, 8)


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


def soa_substep_program(rounds: int = ROUNDS) -> cgen.CProgram:
    """``substep_program`` on a ``cgen.CProgram``: one SSA statement (and
    one node) per operation, the loads of q and v, the stores of q_out. Both
    designs' bodies are emitted from it."""
    prog = cgen.CProgram()
    q = [prog.load("q", r) for r in range(NQ)]
    v = [prog.load("v", r) for r in range(NV)]
    math_ = SimpleNamespace(**{f: (lambda x, f=f: prog.unary(f, x))
                               for f in ("rsqrt", "cos", "sin", "abs")})
    for r, x in enumerate(substep_program(q, v, rounds, math_)):
        prog.store("q_out", r, x)
    return prog


def soa_substep_body(rounds: int = ROUNDS) -> str:
    """C source of ``soa_substep_body`` (``csrc/probe_soa.cuh``'s body):
    ``soa_substep_program`` as one thread's straight-line body, row r of
    env b at ``ptr[r * B + b]``."""
    prog = soa_substep_program(rounds)
    header = (
        "// Generated by puppax_torch/probes/pallas_soa_probe.py from the synthetic\n"
        f"// SoA substep at {rounds} rounds, {prog.count} values. Do not edit.\n"
        "PUPPAX_HD inline void soa_substep_body(SOA_PARAMS, int B, int b) {\n"
    )
    return header + "\n".join(prog.lines) + "\n}\n"


def soa_substep_team_body(rounds: int = ROUNDS, warps: int = TEAM_WARPS,
                          cap: int = TEAM_CAP):
    """(C source, stats) of ``soa_substep_team_body``
    (``csrc/probe_soa_team.cuh``'s body): ``soa_substep_program(rounds)``
    split across ``warps`` warps by ``kernels/team.py``'s ``team_body``
    with the stage budget ``cap`` and no crossing cost (the schedule the
    card measured); the stats' ``ops_per_env`` is the one-thread body's
    count."""
    return team_body(soa_substep_program(rounds), warps, "soa_substep_team_body", "SOA_PARAMS",
                     f"synthetic SoA substep at {rounds} rounds", cap=cap, cross=0.0)


def _team_warps(warps) -> int:
    return TEAM_WARPS if warps is None else int(warps)


def team_variant(rounds: int = ROUNDS, warps=None) -> str:
    """The team build's variant: its rounds, then its warps where they are
    not ``TEAM_WARPS``."""
    warps = _team_warps(warps)
    return f"{int(rounds)} rounds" + ("" if warps == TEAM_WARPS else f", {warps} warps")


def library(rounds: int = ROUNDS, team: bool = False, warps=None):
    """The kernel of ``rounds`` rounds, built at first use: one thread per env
    (``build.probe_soa_library`` around ``soa_substep_body(rounds)``) or,
    with ``team``, the team design (``build.probe_soa_team_library`` around
    ``soa_substep_team_body(rounds, warps)``)."""
    if not team:
        return build.probe_soa_library(rounds, lambda: soa_substep_body(rounds))
    warps = _team_warps(warps)
    return build.probe_soa_team_library(rounds, warps, team_variant(rounds, warps),
                                        lambda: soa_substep_team_body(rounds, warps))


def soa_name(rounds: int = ROUNDS, team: bool = False, warps=None) -> str:
    """The launch name of one build: ``soa_substep`` (``soa_substep_team``),
    with the round count where it is not the TPU probe's 60, and a team
    build's warps where they are not ``TEAM_WARPS``."""
    name = "soa_substep_team" if team else "soa_substep"
    name += "" if rounds == ROUNDS else f"_{rounds}_rounds"
    if team and _team_warps(warps) != TEAM_WARPS:
        name += f"_{_team_warps(warps)}_warps"
    return name


def record(rounds: int = ROUNDS, team: bool = False, warps=None) -> str:
    """The build's ``build.last_build`` record: ``probe_soa[<rounds> rounds]``
    or ``probe_soa_team[<team_variant>]``."""
    if team:
        return build.record_name(build.PROBE_SOA_TEAM, team_variant(rounds, warps))
    return build.record_name(build.PROBE_SOA, f"{int(rounds)} rounds")


def soa_substep(q: torch.Tensor, v: torch.Tensor, out: torch.Tensor, rounds: int = ROUNDS,
                team: bool = False, warps=None):
    """One substep of q ``(19, B)`` and v ``(18, B)`` into the preallocated
    ``out`` ``(19, B)`` (another buffer than q's), every block contiguous
    float32 on one device. CPU tensors run the plain version
    (``soa_substep_rows``); CUDA tensors launch the kernel of
    ``csrc/probe_soa.cuh`` (one thread per env) or, with ``team``, of
    ``csrc/probe_soa_team.cuh`` (``warps`` warps per 32-env block, default
    ``TEAM_WARPS``) on the current stream, or raise. Each launch counts in
    ``common.launches[soa_name(rounds, team, warps)]``. The team kernel
    sizes its shared memory at its first launch, so launch it once eagerly
    before capturing it in a CUDA graph."""
    B, dev = build.check_blocks((NQ, NV, NQ), (q, v, out))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"soa_substep: unsupported device {dev}")
    if out.data_ptr() in (q.data_ptr(), v.data_ptr()):
        raise ValueError("soa_substep: out must not be q's or v's buffer")
    if team and not 1 <= _team_warps(warps) <= 32:
        raise ValueError(f"soa_substep: {warps} warps")
    if dev.type == "cpu":
        out.copy_(soa_substep_rows(q, v, rounds))
        return
    lib = library(rounds, team, warps)
    if team:
        build.launch_into("probe_soa_team", lib.probe_soa_team_launch, [q, v, out], B)
    else:
        build.launch_into("probe_soa", lib.probe_soa_launch, [q, v, out], B)
    common.count_launch(soa_name(rounds, team, warps))


def soa_inputs(B: int, seed: int, device):
    """q ``(19, B)`` then v ``(18, B)``, standard normals from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((NQ, B)).astype(np.float32)
    v = rng.standard_normal((NV, B)).astype(np.float32)
    return torch.from_numpy(q).to(device), torch.from_numpy(v).to(device)


def check(q: torch.Tensor, v: torch.Tensor, rounds: int = ROUNDS, team: bool = False,
          warps=None) -> Dict[str, object]:
    """One ``soa_substep`` launch held bit for bit against
    ``soa_substep_rows`` on the same blocks and, for a ``team`` build,
    against one launch of the one-thread kernel; raises if an env differs
    or the plain version is not finite. Returns ``max_abs_err``,
    ``differing`` envs and the plain version's ``plain_ms`` (a team build
    adds ``one_thread_differing``)."""
    got = torch.empty_like(q)
    soa_substep(q, v, got, rounds, team, warps)
    want = []
    plain_ms = common.window_ms(lambda: want.append(soa_substep_rows(q, v, rounds)))
    err, differing = common.compare_exact([got], [want[0]])
    res = dict(max_abs_err=err, differing=differing, plain_ms=plain_ms)
    if team:
        one = torch.empty_like(q)
        soa_substep(q, v, one, rounds)
        res["one_thread_differing"] = common.compare_exact([got], [one])[1]
    name = soa_name(rounds, team, warps)
    if differing or res.get("one_thread_differing") or not bool(torch.isfinite(want[0]).all()):
        raise AssertionError(f"{name}: {differing} of {q.shape[1]} envs differ from the plain "
                             f"version ({res.get('one_thread_differing', 0)} from the one-thread "
                             f"kernel), or it is not finite")
    return res


def _build_info(rec: str) -> dict:
    info = build.last_build[rec]
    return dict(lines=info["lines"], ops_per_env=info["ops_per_env"],
                nvcc_s=info["compile_seconds"], **common.ptxas_info(rec))


def run(device, rounds_list: Sequence[int] = (ROUNDS,), B: int = B_DEFAULT, seed: int = 0,
        check_envs: Sequence[int] = (B_DEFAULT, common.TILE), chain: int = CHAIN,
        runs: int = RUNS, team_warps: Sequence[int] = ()) -> Dict[int, dict]:
    """For each round count (built before, ``library``): the one-thread
    kernel and the team kernel at each of ``team_warps`` held against the
    plain version (a team build also against the one-thread kernel) at each of
    ``check_envs`` (the first envs of the inputs), then ``chain`` chained
    substeps at ``B`` envs timed, the designs in turns (one-thread, the
    team builds, the team builds reversed, one-thread). Returns, per
    round count, the one-thread kernel's ``checks`` (envs -> ``check``'s
    dict), ``eager_us`` and ``graph_us`` per substep (the median of its two
    turns), ``plain_ms`` at B, ``envs``, ``lines``, ``ops_per_env``,
    ``nvcc_s``, ptxas's ``registers``, ``stack``, ``spill_stores``,
    ``spill_loads``, and ``ns_per_op`` (the graphed time over one env's
    operations); under ``team`` the same per warps, with the schedule's
    ``heaviest`` stream, ``barriers``, ``shared_bytes``,
    ``replicated_ops``, ``ns_per_heaviest_op`` and the one-thread kernel's
    time over the team's (``speedup``)."""
    q, v = soa_inputs(B, seed, device)
    print(common.nvidia_smi(), flush=True)
    print(f"synthetic SoA substep at {B} envs: {chain} chained substeps per window (q carried), "
          f"best of {runs} windows (CUDA events), eager and from one CUDA graph; one thread "
          f"per env and the team kernel at warps {list(team_warps)} in turns:", flush=True)
    results = {}
    for rounds in rounds_list:
        designs = [dict(team=False)] + [dict(team=True, warps=w) for w in team_warps]
        checks = []
        for d in designs:
            checks.append({})
            for n in check_envs:
                res = check(q[:, :n].contiguous(), v[:, :n].contiguous(), rounds, **d)
                checks[-1][n] = res
                print(f"{soa_name(rounds, **d)} vs plain ({rounds} rounds) at {n} envs: max abs "
                      f"err {res['max_abs_err']!r}, {res['differing']} envs differ"
                      + (f"; vs the one-thread kernel: {res['one_thread_differing']} envs differ"
                         if d["team"] else ""), flush=True)
        carries = []
        for d in designs:
            carry = common.Carry(lambda a, b, d=d: soa_substep(a, v, b, rounds, **d), (q,), chain)
            carry.reset()
            carry.window()
            if not bool(torch.isfinite(carry.sets[chain % 2][0]).all()):
                raise AssertionError(f"{soa_name(rounds, **d)}: {chain} chained substeps are "
                                     f"not finite")
            carries.append(carry)
        times = [[] for _ in designs]
        order = list(range(len(designs)))
        for i in [0] + order[1:] + order[:0:-1] + [0]:
            times[i].append(common.eager_and_graph_ms(carries[i].window, runs, carries[i].reset))
        plain = []
        plain_ms = common.window_ms(lambda: plain.append(soa_substep_rows(q, v, rounds)))
        per = []
        for d, chk, ts in zip(designs, checks, times):
            res = dict(checks=chk, eager_us=statistics.median(e for e, _ in ts) * 1e3 / chain,
                       graph_us=statistics.median(g for _, g in ts) * 1e3 / chain,
                       plain_ms=plain_ms, envs=B, **_build_info(record(rounds, **d)))
            res["ns_per_op"] = res["graph_us"] * 1e3 / res["ops_per_env"]
            per.append(res)
        one = per[0]
        one["team"] = {}
        print(f"{soa_name(rounds):28s} {rounds:4d} rounds: {one['lines']} lines, "
              f"{one['ops_per_env']} ops per env, nvcc {one['nvcc_s']:.1f} s, "
              f"{one['registers']} registers, stack {one['stack']} B, spills "
              f"{one['spill_stores']} / {one['spill_loads']} B; eager {one['eager_us']:9.3f} us, "
              f"graph {one['graph_us']:9.3f} us per substep, {one['ns_per_op']:.4f} ns per "
              f"env-op; plain {plain_ms:.3f} ms", flush=True)
        for w, res in zip(team_warps, per[1:]):
            info = build.last_build[record(rounds, True, w)]
            res.update(heaviest=max(info["stream_ops"]), barriers=info["barriers"],
                       shared_bytes=info["shared_bytes"], replicated_ops=info["replicated_ops"],
                       warps=w, speedup=one["graph_us"] / res["graph_us"])
            res["ns_per_heaviest_op"] = res["graph_us"] * 1e3 / res["heaviest"]
            one["team"][w] = res
            print(f"{soa_name(rounds, True, w):28s} {rounds:4d} rounds, {w} warps: heaviest "
                  f"stream {res['heaviest']} of {res['ops_per_env']} ops, "
                  f"{res['barriers']} barriers, {res['shared_bytes']} B shared, "
                  f"{res['lines']} lines, nvcc {res['nvcc_s']:.1f} s, {res['registers']} "
                  f"registers, stack {res['stack']} B, spills {res['spill_stores']} / "
                  f"{res['spill_loads']} B; eager {res['eager_us']:9.3f} us, graph "
                  f"{res['graph_us']:9.3f} us per substep ({res['speedup']:.3f}x the "
                  f"one-thread kernel), {res['ns_per_heaviest_op']:.4f} ns per heaviest-stream "
                  f"op", flush=True)
        results[rounds] = one
    return results


def build_all(rounds_list: Sequence[int], team_warps: Sequence[int] = ()) -> list:
    """The one-thread kernel of each round count and its team kernel at each
    of ``team_warps``, at once; returns their ``build.last_build`` names."""
    builds = [(r, dict(team=False)) for r in rounds_list]
    builds += [(r, dict(team=True, warps=w)) for r in rounds_list for w in team_warps]
    build.build_in_parallel(*[(lambda r=r, d=d: library(r, **d)) for r, d in builds])
    return [record(r, **d) for r, d in builds]


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", default=",".join(map(str, CLI_ROUNDS)),
                    help="comma-separated round counts, one build each")
    ap.add_argument("--envs", type=int, default=B_DEFAULT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--team", action="store_true",
                    help="also the team design, at each of --warps")
    ap.add_argument("--warps", default=",".join(map(str, CLI_WARPS)),
                    help="comma-separated warps per block of the team builds")
    args = ap.parse_args(argv)
    rounds_list = _ints(args.rounds)
    warps = _ints(args.warps) if args.team else []
    common.require_cuda("pallas_soa_probe")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    common.print_builds(build_all(rounds_list, warps))
    results = run(device, rounds_list, args.envs, args.seed,
                  check_envs=(args.envs, min(args.envs, common.TILE)), team_warps=warps)
    print("nvcc seconds and graphed us per substep against the body's size:", flush=True)
    for r, res in results.items():
        for name, x in [("one-thread", res)] + [(f"team {w} warps", x)
                                                for w, x in res["team"].items()]:
            team_cols = (f", heaviest {x['heaviest']:6d}, {x['barriers']:5d} barriers, "
                         f"{x['shared_bytes']:6d} B shared" if "heaviest" in x else "")
            print(f"  {r:4d} rounds {name:22s}: {x['lines']:6d} lines, {x['ops_per_env']:6d} "
                  f"ops{team_cols}, nvcc {x['nvcc_s']:6.1f} s, {x['registers']} registers, "
                  f"spills {x['spill_stores']} B, {x['graph_us']:9.3f} us, "
                  f"{x['ns_per_op']:.4f} ns per env-op", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
