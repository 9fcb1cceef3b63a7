"""How do the team kernels' schedule knobs set their time on the card?

    python -m puppax_torch.probes.profile_team [--kernel K1|K2] [--variants W:cap:cross:kb,...]

Team K1 and team K2 (``csrc/physics_step_team.cuh``, ``csrc/env_step_team.cuh``)
run each env's program split across the W warps of a block by
``kernels/team.py``, whose schedule has four knobs: the warps per block W,
a warp's budget of weighted operations per stage (``team.CAP``), the cost
in stages of sending one more operand through shared memory
(``team.CROSS``), and the shared memory the slots may fill
(``team.SHARED_BUDGET``, in KB here: within it a value is written to its
slot as soon as it is computed, beyond it just before its first read, so
the budget trades shared memory for the owner's registers); and one of
its rendering: the unroll pragma of the line search's row sums
(``team.SUM_UNROLL``). This probe
builds the kernel at each variant (all nvcc at once) beside the one-thread
kernel, holds each launch bit for bit against the one-thread kernel's and
times each at 4096 and 128 envs (best of 3 windows of 20 launches on the
same inputs, CUDA events), with each build's schedule (stages, barriers,
heaviest stream, shared bytes, the write gap) and ptxas summary.
``--trips E,I`` emits both with other line-search trip counts, which
prices the line search (a timing variant: another program). Inputs:
``profile_layout.team_blocks`` (nominal states). No counterpart on the
TPU: the team kernels are the H100's design of K1 and K2.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from puppax_torch.kernels import build, cgen, team
from puppax_torch.physics import soa
from puppax_torch.probes import common, profile_layout

def parse_variants(text: str) -> Tuple[tuple, ...]:
    """``W:cap:cross:kb[:sum_unroll]``, comma-separated."""
    out = []
    for v in text.split(","):
        f = v.split(":")
        out.append((int(f[0]), int(f[1]), float(f[2]), int(f[3]),
                    int(f[4]) if len(f) > 4 else team.SUM_UNROLL))
    return tuple(out)


# (W, cap, cross, shared KB, sum unroll): the production schedule at 4 and
# 8 warps, and each knob moved once
VARIANTS = parse_variants("4:48:1:227,8:48:1:227,4:48:1:160,4:96:1:227,4:24:1:227,4:48:0:227,"
                          "4:48:1:227:0,4:48:1:227:10")


def _label(v: tuple) -> str:
    return f"W={v[0]} cap={v[1]} cross={v[2]} {v[3]} KB sum unroll {v[4]}"


def build_variants(s, es, n_substeps: int, kernel: str, variants: Sequence[tuple],
                   trips: Optional[Tuple[int, int]] = None):
    """The one-thread kernel's and each team variant's launch function and
    build stats, all nvcc at once. ``trips`` (expand, Illinois) emits the
    line search with other trip counts than ``soa.LS_EXPAND_ITERS`` /
    ``LS_ILLINOIS_ITERS`` (a timing variant only: it is another program)."""
    saved = soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS
    if trips:
        soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS = trips
    try:
        if kernel == "K1":
            prog, one_body = cgen.physics_step_program(s, n_substeps), \
                cgen.physics_step_body(s, n_substeps)
            shells = build.PHYSICS_STEP, build.PHYSICS_STEP_TEAM
            name, params = "physics_step_team_body", "PS_PARAMS"
        else:
            prog, one_body = cgen.env_step_program(s, es, n_substeps), \
                cgen.env_step_body(s, es, n_substeps)
            shells = build.ENV_STEP, build.ENV_STEP_TEAM
            name, params = "env_step_team_body", "ES_PARAMS"
    finally:
        soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS = saved
    bodies = [(one_body, {"ops_per_env": cgen.op_count(one_body)})]
    bodies += [team.team_body(prog, w, name, params, f"{kernel} emission, variant {v}", cap,
                              cross, kb * 1024, unroll)
               for v in variants for w, cap, cross, kb, unroll in [v]]
    nvcc = build.nvcc_path()
    jobs = [lambda src=src, sh=sh: build.compile_library(
        sh, src, [nvcc], build.NVCC_FLAGS, build.BUILD_ROOT, f"lib{sh.name}.so")
        for (src, _), sh in zip(bodies, [shells[0]] + [shells[1]] * len(variants))]
    fns = []
    for (path, _, secs), (_, stats), sh in zip(build.build_in_parallel(*jobs), bodies,
                                               [shells[0]] + [shells[1]] * len(variants)):
        fns.append(build._bind(ctypes.CDLL(str(path)), sh, with_stream=True))
        with open(path.parent / "build.log") as f:
            stats["ptxas"] = common.ptxas_of_log(f.read())
        stats["compile_seconds"] = secs
    return fns, [stats for _, stats in bodies]


def run(s, es, n_substeps: int, kernel: str, blocks: Dict[int, list],
        variants: Sequence[tuple] = VARIANTS, trips: Optional[Tuple[int, int]] = None,
        iters: int = 20, runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Time each variant of team ``kernel`` on ``blocks`` ({B: input blocks});
    returns {(variant, B): {"us", ...}} and fails unless each launch equals
    the one-thread kernel's bit for bit."""
    from puppax_torch.env import soa_env

    out_rows = soa.physics_block_rows(s)[1] if kernel == "K1" else \
        soa_env.env_block_rows(s, es)[1]
    (one, *fns), (one_stats, *stats) = build_variants(s, es, n_substeps, kernel, variants, trips)
    print(common.nvidia_smi(), flush=True)
    p = one_stats["ptxas"]
    print(f"one-thread {kernel}{f' at line-search trips {trips}' if trips else ''}: "
          f"{one_stats['ops_per_env']} ops per env; {p['registers']} registers, "
          f"{p['spill_stores']} B spill stores; nvcc {one_stats['compile_seconds']:.1f} s",
          flush=True)
    for v, st in zip(variants, stats):
        p = st["ptxas"]
        print(f"team {kernel} {_label(v)}: "
              f"stages {st['stages']}, {st['barriers']} barriers, heaviest stream "
              f"{max(st['stream_ops'])} of {st['ops_per_env']} ops, {st['shared_bytes']} B "
              f"shared, write gap {st['write_gap']}; {p['registers']} registers, "
              f"{p['spill_stores']} B spill stores, {p['spill_loads']} B spill loads; nvcc "
              f"{st['compile_seconds']:.1f} s", flush=True)
    results = {}
    for B, bl in blocks.items():
        dev = bl[0].device
        ref = build.launch("one-thread", one, bl, out_rows, B, dev)
        base = common.best_ms(lambda: [build.launch("one-thread", one, bl, out_rows, B, dev)
                                       for _ in range(iters)], runs) * 1e3 / iters
        print(f"{kernel} {B} envs one-thread: {base:.1f} us", flush=True)
        for v, fn in zip(variants, fns):
            got = build.launch("team", fn, bl, out_rows, B, dev)
            torch.cuda.synchronize()
            _, differing = common.compare_exact(got, ref)
            if differing:
                raise AssertionError(f"team {kernel} {v} at {B} envs: {differing} envs differ "
                                     "from the one-thread kernel")
            us = common.best_ms(lambda: [build.launch("team", fn, bl, out_rows, B, dev)
                                         for _ in range(iters)], runs) * 1e3 / iters
            results[(v, B)] = dict(us=us, one_thread_us=base)
            print(f"{kernel} {B} envs {_label(v)}: {us:.1f} us "
                  f"({base / us:.2f}x the one-thread kernel)", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("K1", "K2"), default="K1")
    ap.add_argument("--variants", type=parse_variants, default=VARIANTS,
                    help="comma-separated W:cap:cross:shared_kb[:sum_unroll]")
    ap.add_argument("--trips", type=lambda t: tuple(int(x) for x in t.split(",")),
                    default=None, help="the line search's expand,Illinois trips (a timing "
                    "variant: another program than the production one)")
    args = ap.parse_args(argv)
    common.require_cuda("profile_team")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    env, blocks = profile_layout.team_blocks(device)
    run(env._s, env._es, env._n_substeps, args.kernel, blocks[args.kernel], args.variants,
        args.trips)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
