"""How do the team kernels' schedule knobs set their time on the card?

    python -m puppax_torch.probes.profile_team [--kernel K1|K2|K3] [--variants W:cap:cross:kb,...]
    python -m puppax_torch.probes.profile_team --kernel K4 [--warps 4,6,8] [--rows 1,4,8,16]
    python -m puppax_torch.probes.profile_team --kernel P7 [--warps 2,4,8] [--caps 16,48,128]

Team K1, team K2 and team K3 (``csrc/physics_step_team.cuh``,
``csrc/env_step_team.cuh``, ``csrc/wrapped_step_team.cuh``) run each env's program split across the W warps of a block by
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
TPU: the team kernels are the H100's design of K1, K2 and K3.

``--kernel K3`` sweeps team K3 at W = 4, 6 and 8 by default (``K3_VARIANTS``,
the production schedule otherwise) at 4096 envs only, on ``k3_inputs``:
the 8 input blocks of one wrapped step of a DR'd reset of the default
training configuration, random actions in [-1, 1].

``--kernel K4`` (``run_k4``) sweeps team K4 (``csrc/fused_unroll_team.cuh``)
instead: the whole kernel at each W of ``--warps`` (the MLP at
``build.K4_MLP_ROWS`` outputs per thread) and at the production W with
each other R of ``--rows``, held bit for bit against the one-thread K4
and timed per T=20 unroll at 4096 envs beside it (best of 3 windows, CUDA
events); then its MLP alone, the probe variant without the env step
(``cgen.fused_unroll_team_body(..., mlp_only=True)``: the observation,
the MLP, the head and the clock, with the whole kernel's shared memory),
at each W and each R, its first step held bit for bit against the
one-thread K4's,
timed from a CUDA graph per step beside a ``torch.nn.functional.linear``
chain of the same folded layers on the same 4096 x 72 observations, also
from a CUDA graph. Inputs: ``k4_inputs`` (a nominal reset of the default
env, the default policy with random weights).

``--kernel P7`` (``run_p7``) sweeps P7's team build instead: the fk cut of
K1 (``dev/profile_overhead.py::call_fk``) with its substep loop partitioned
(loop weight ``profile_overhead.P7_LOOP_WEIGHT``), at each W of ``--warps``
(default ``P7_WARPS``) and each stage budget of ``--caps`` (default
``P7_CAPS``), beside the one-thread fk cut and production's team fk
schedule (the loop replicated), all nvcc at once. For each build: the
heaviest stream, replicated operations, barriers, shared bytes, ptxas's
registers, stack and spills, the SASS instruction mix of the whole kernel
(``common.sass_functions``: FP32 operations, MUFU, global and shared loads
and stores, barriers), and per rendered stream its operations, input-row
reads, stores and shared reads and writes (``team.stream_traffic``); then
each held bit for bit against the plain fk cut and timed at 4096 and 128
envs (50 carried launches per window from one CUDA graph, best of 3),
with the ns per heaviest-stream operation. Inputs: the nominal blocks.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from puppax_torch import random
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
# team K3's sweep: the warps per block at the production schedule
K3_VARIANTS = parse_variants("4:48:1:227,6:48:1:227,8:48:1:227")


def _label(v: tuple) -> str:
    return f"W={v[0]} cap={v[1]} cross={v[2]} {v[3]} KB sum unroll {v[4]}"


def build_variants(s, es, n_substeps: int, kernel: str, variants: Sequence[tuple],
                   trips: Optional[Tuple[int, int]] = None,
                   episode_length: Optional[int] = None):
    """The one-thread kernel's and each team variant's launch function and
    build stats, all nvcc at once (K3 bakes ``episode_length`` into its
    body). ``trips`` (expand, Illinois) emits the
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
        elif kernel == "K3":
            prog, one_body = cgen.wrapped_step_program(s, es, n_substeps, episode_length), \
                cgen.wrapped_step_body(s, es, n_substeps, episode_length)
            shells = build.WRAPPED_STEP, build.WRAPPED_STEP_TEAM
            name, params = "wrapped_step_team_body", "WS_PARAMS"
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
        iters: int = 20, runs: int = common.RUNS,
        episode_length: Optional[int] = None) -> Dict[tuple, dict]:
    """Time each variant of team ``kernel`` on ``blocks`` ({B: input blocks});
    returns {(variant, B): {"us", ...}} and fails unless each launch equals
    the one-thread kernel's bit for bit."""
    from puppax_torch.env import soa_env

    out_rows = {"K1": lambda: soa.physics_block_rows(s)[1],
                "K2": lambda: soa_env.env_block_rows(s, es)[1],
                "K3": lambda: soa_env.block_rows(s, es)[1]}[kernel]()
    (one, *fns), (one_stats, *stats) = build_variants(s, es, n_substeps, kernel, variants, trips,
                                                      episode_length)
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


def k3_inputs(device, B: int = 4096, seed: int = 0):
    """(env, episode length, the 8 input blocks of one wrapped step) of the
    default training configuration: a DR'd reset of ``B`` envs, the
    reset's first noise draw (keys from ``seed``), random actions in [-1, 1]
    (a generator seeded with ``seed``)."""
    from puppax_torch.configs import DomainRandomizationConfig, EnvConfig, TrainConfig
    from puppax_torch.env.domain_randomization import domain_randomize
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training

    tc, dr_cfg = TrainConfig(), DomainRandomizationConfig()
    g = torch.Generator(device=device).manual_seed(seed)
    key_dr, key_env = random.split(random.key(seed, device)).unbind(0)
    env = PupperV3Env.from_config(EnvConfig(), device=device)
    ranges = {k: v for k, v in vars(dr_cfg).items() if k != "enabled"}
    wrapped = wrap_for_training(
        env, tc.episode_length,
        randomization_fn=lambda m, keys: domain_randomize(m, keys, **ranges),
        randomization_keys=random.split(key_dr, B))
    lane = FastLane(wrapped)
    state = wrapped.reset(random.split(key_env, B))
    carry = lane.carry_from_state(state)
    _, noise, _ = lane.draw_noise_block(state.info["rng"], 1)
    act = torch.rand((env.action_size, B), generator=g, device=device) * 2 - 1
    return env, tc.episode_length, [carry["q"], carry["v"], act, carry["env"],
                                    noise[0].contiguous(), carry["dr"], carry["first"],
                                    carry["wrap"]]


K4_WARPS = (4, 6, 8)
K4_ROWS = (1, 4, 8, 16)
_F_ACT = {"elu": torch.nn.functional.elu, "relu": torch.relu, "tanh": torch.tanh,
          "sigmoid": torch.sigmoid, "softmax": lambda x: torch.softmax(x, 1)}


def k4_inputs(device, B: int = 4096, T: int = 20, seed: int = 0):
    """(env, episode length, activation, folded layers, the 9 input blocks)
    of one T-step unroll of the default configuration from a nominal reset
    of ``B`` envs (the default policy, random weights from ``seed``, the
    initial normalizer)."""
    from puppax_torch.configs import EnvConfig, TrainConfig
    from puppax_torch.env import fused_unroll
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.train import networks, running_statistics

    env, tc = PupperV3Env.from_config(EnvConfig(), device=device), TrainConfig()
    key_env, key_eps, key_net = random.split(random.key(seed, device), 3).unbind(0)
    wrapped = wrap_for_training(env, tc.episode_length)  # the nominal model
    lane = FastLane(wrapped)
    state = wrapped.reset(random.split(key_env, B))
    carry = lane.carry_from_state(state)
    _, noise, _ = lane.draw_noise_block(state.info["rng"], T)
    eps = lane.draw_eps(key_eps, B, T).transpose(1, 2).contiguous()
    policy = networks.make_ppo_networks(
        env.observation_size, env.action_size, tc.policy_hidden_layer_sizes,
        tc.value_hidden_layer_sizes, tc.activation, device=device, key=key_net).policy_network
    layers = fused_unroll.fold_normalizer(
        running_statistics.init_state(env.observation_size, device=device), policy)
    blocks = [carry[k] for k in ("q", "v", "env", "wrap")] + [
        carry.get("phase"), carry["first"], carry["dr"], noise, eps]
    return env, tc.episode_length, tc.activation, layers, blocks


def _flat(xs):
    return [x.reshape(-1, x.shape[-1]) for x in xs if x is not None]


def run_k4(env, episode_length: int, activation: str, layers, blocks,
           warps: Sequence[int] = K4_WARPS, rows: Sequence[int] = K4_ROWS,
           runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Sweep team K4 on one unroll's inputs (``k4_inputs``); returns
    {("K4", W, R): {"ms", "one_thread_ms"}, ("MLP", W, R): {"us_per_step"},
    "linear_us": ...}, and fails unless each whole-kernel variant equals the
    one-thread K4 bit for bit and each MLP variant's first step its first
    step."""
    from puppax_torch.env import fused_unroll

    s, es, n, L = env._s, env._es, env._n_substeps, episode_length
    T, B = blocks[-1].shape[0], blocks[0].shape[1]
    w0 = build.TEAM_WARPS[build.FUSED_UNROLL_TEAM.name]
    team_cases = [(w, build.K4_MLP_ROWS) for w in warps] + [
        (w0, r) for r in rows if r != build.K4_MLP_ROWS]
    mlp_cases = [(w, r) for w in warps for r in rows]
    libs = build.build_in_parallel(
        lambda: build.fused_unroll_library(s, es, n, L),
        *[lambda w=w, r=r: build.fused_unroll_team_library(s, es, n, L, w, r)
          for w, r in team_cases],
        *[lambda w=w, r=r: build.fused_unroll_team_library(s, es, n, L, w, r, mlp_only=True)
          for w, r in mlp_cases])
    one, teams, mlps = libs[0], libs[1 : 1 + len(team_cases)], libs[1 + len(team_cases) :]
    print(common.nvidia_smi(), flush=True)
    for name, info in build.last_build.items():
        if name.startswith("fused_unroll"):
            p = common.ptxas_info(name)
            print(f"build {name}: nvcc {info['compile_seconds']:.1f} s; {p['registers']} "
                  f"registers, {p['stack']} B stack, {p['spill_stores']} B spill stores; "
                  + (f"{info['barriers']} barriers, {info['shared_bytes']} B shared, heaviest "
                     f"stream {max(info['stream_ops'])} ops" if "barriers" in info else ""),
                  flush=True)

    def call(lib, team_kernel=True):  # on the current stream: the capture's in a graph
        entry = "fused_unroll_team_launch" if team_kernel else "fused_unroll_launch"
        weights = (fused_unroll.team_weights if team_kernel else
                   fused_unroll.one_thread_weights)(layers)
        return fused_unroll.kernel_call(getattr(lib, entry), s, es, activation, layers, weights,
                                        *blocks,
                                        stream=torch.cuda.current_stream().cuda_stream)

    ref = call(one, False)
    results = {}
    one_ms = common.best_ms(lambda: call(one, False), runs)
    print(f"one-thread K4: {one_ms:.3f} ms per T={T} unroll at {B} envs", flush=True)
    for (w, r), lib in zip(team_cases, teams):
        _, differing = common.compare_exact(_flat(call(lib)), _flat(ref))
        if differing:
            raise AssertionError(f"team K4 on {w} warps, R={r}: {differing} envs differ from "
                                 "the one-thread K4")
        ms = common.best_ms(lambda: call(lib), runs)
        results[("K4", w, r)] = dict(ms=ms, one_thread_ms=one_ms)
        print(f"team K4 W={w} R={r}: {ms:.3f} ms per T={T} unroll "
              f"({one_ms / ms:.2f}x the one-thread K4), bit for bit", flush=True)
    first = [x[0] for x in ref[5:9]]  # the first step's obs, act, raw, logp
    for (w, r), lib in zip(mlp_cases, mlps):
        _, differing = common.compare_exact(_flat([x[0] for x in call(lib)[5:9]]), _flat(first))
        if differing:
            raise AssertionError(f"team K4's MLP on {w} warps, R={r}: {differing} envs differ")
        _, graph_ms = common.eager_and_graph_ms(lambda: call(lib), runs)
        results[("MLP", w, r)] = dict(us_per_step=graph_ms * 1e3 / T)
        print(f"team K4 MLP alone W={w} R={r}: {graph_ms * 1e3 / T:.2f} us per step (graph, "
              f"observation + MLP + head + clock), first step bit for bit", flush=True)
    r0, hist = es.env_rows["obs_history"]
    x = blocks[2][r0 : r0 + hist].t().contiguous()

    def chain():
        h = x
        for i, (wt, b) in enumerate(layers):
            h = torch.nn.functional.linear(h, wt, b)
            if i != len(layers) - 1:
                h = _F_ACT[activation](h)
        return h

    _, linear_ms = common.eager_and_graph_ms(chain, runs)
    results["linear_us"] = linear_ms * 1e3
    print(f"torch.nn.functional.linear chain of the same layers on ({B}, {x.shape[1]}): "
          f"{linear_ms * 1e3:.2f} us per step (graph)", flush=True)
    return results


P7_WARPS = (2, 4, 8)
P7_CAPS = (16, 48, 128)
SASS_MIX = ("FFMA", "FMUL", "FADD", "MUFU", "LDG", "STG", "LDS", "STS", "BAR")


def sass_mix(record: str, kernel: build.Kernel) -> Optional[dict]:
    """Instructions of a build's kernel functions by mnemonic (``SASS_MIX``
    and ``total``); None where the toolkit has no cuobjdump."""
    text = common.sass_text(record, kernel)
    return None if text is None else common.mnemonic_counts(text, SASS_MIX)


def one_stream(source: str, keep: Optional[int]) -> str:
    """A rendered team body with the case of every warp but ``keep`` emptied
    (None: every case): compiled, not run, its SASS is that one stream's
    (each case is its own code, ``team.render``) plus the shell's."""
    out, skip = [], False
    for line in source.splitlines(keepends=True):
        m = re.match(r"  case (\d+): \{$", line.rstrip("\n"))
        if m:
            out.append(line)
            skip = int(m.group(1)) != keep
            continue
        if line == "  } break;\n":
            skip = False
        if not skip:
            out.append(line)
    return "".join(out)


def stream_sass(s, n_substeps: int, knobs: dict) -> Optional[list]:
    """Each stream of the fk cut's team build at ``knobs`` alone: the SASS mix
    (``SASS_MIX``) of the body with only that warp's case, less that of the
    body with every case emptied (the shell), all nvcc at once; None where
    the toolkit has no cuobjdump."""
    source, _ = team.physics_step_team_body(s, n_substeps, knobs["warps"], "fk", sink=True,
                                            loop_weight=knobs["loop_weight"], cap=knobs["cap"])
    nvcc = build.nvcc_path()
    bodies = [one_stream(source, w) for w in range(knobs["warps"])] + [one_stream(source, None)]
    built = build.build_in_parallel(*[lambda src=src: build.compile_library(
        build.PROBE_PHYSICS_TEAM, src, [nvcc], build.NVCC_FLAGS, build.BUILD_ROOT,
        f"lib{build.PROBE_PHYSICS_TEAM.name}.so") for src in bodies])
    texts = [common.sass_of(path) for path, _, _ in built]
    if texts[0] is None:
        return None
    mixes = [common.mnemonic_counts(x, SASS_MIX) for x in texts]
    return [{k: m[k] - mixes[-1][k] for k in m} for m in mixes[:-1]]


def run_p7(s, n_substeps: int, blocks, warps: Sequence[int] = P7_WARPS,
           caps: Sequence[int] = P7_CAPS, envs: Sequence[int] = (4096, common.TILE),
           iters: int = common.ITERS, runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Sweep P7's team build over ``warps`` x ``caps`` on ``blocks`` (K1's
    q, v, ctrl, dr; the first envs of each of ``envs``). Returns
    {("one-thread",): ..., ("production",): ..., (W, cap): ...}, each with
    its build's numbers and {B: graph us} under ``us``; fails unless every
    build equals the plain fk cut bit for bit. Under ``"stream_sass"``: each
    stream's SASS mix alone (``stream_sass``) of P7's own build
    (``profile_overhead``'s knobs)."""
    from puppax_torch.probes import profile_overhead as P

    lw = P.P7_LOOP_WEIGHT
    points = [(w, c) for w in warps for c in caps]
    build.build_in_parallel(
        lambda: build.probe_physics_library(s, n_substeps, "fk"),
        lambda: build.probe_physics_team_library(s, n_substeps, "fk"),
        *[lambda w=w, c=c: build.probe_physics_team_library(s, n_substeps, "fk", warps=w,
                                                            loop_weight=lw, cap=c)
          for w, c in points])
    prog = cgen.physics_step_program(s, n_substeps, "fk", sink=True)
    production = dict(warps=build.TEAM_WARPS["physics_step_team"],
                      loop_weight=team.REPLICATED_LOOP_WEIGHT, cap=team.CAP)
    cases = {("one-thread",): (build.record_name(build.PROBE_PHYSICS, "fk"), None),
             ("production",): (build.record_name(build.PROBE_PHYSICS_TEAM, "fk"), production)}
    for w, c in points:
        cases[(w, c)] = (build.record_name(build.PROBE_PHYSICS_TEAM, build.team_probe_variant(
            "fk", w, lw, c)), dict(warps=w, loop_weight=lw, cap=c))
    p7 = dict(warps=P.P7_WARPS, loop_weight=lw, cap=P.P7_CAP)
    results = {"stream_sass": stream_sass(s, n_substeps, p7)}
    print(common.nvidia_smi(), flush=True)
    print(f"P7's build (W={p7['warps']}, cap {p7['cap']}), each stream alone (its case only, "
          f"less the shell), SASS: {results['stream_sass']}", flush=True)
    for key, (record, knobs) in cases.items():
        info, p = build.last_build[record], common.ptxas_info(record)
        kernel = build.PROBE_PHYSICS if knobs is None else build.PROBE_PHYSICS_TEAM
        res = dict(record=record, nvcc_s=info["compile_seconds"], ptxas=p,
                   sass=sass_mix(record, kernel), us={})
        line = (f"P7 {' '.join(map(str, key)):12s}: nvcc {info['compile_seconds']:.1f} s; "
                f"{p['registers']} registers, {p['stack']} B stack, {p['spill_stores']} / "
                f"{p['spill_loads']} B spills; SASS {res['sass']}")
        if knobs is not None:
            sch = team.Schedule(prog, knobs["warps"], knobs["cap"],
                                loop_weight=knobs["loop_weight"])
            res["streams"] = [dict(ops=team.stream_ops(x), **team.stream_traffic(x))
                              for x in team.render_streams(sch)]
            res.update(heaviest=max(info["stream_ops"]), replicated=info["replicated_ops"],
                       barriers=info["barriers"], shared_bytes=info["shared_bytes"])
            line += (f"; heaviest stream {res['heaviest']} of {info['ops_per_env']} ops, "
                     f"{res['replicated']} replicated, {res['barriers']} barriers, "
                     f"{res['shared_bytes']} B shared; per stream (ops, input reads, stores, "
                     f"shared reads, shared writes): "
                     + ", ".join(f"({x['ops']}, {x['loads']}, {x['stores']}, "
                                 f"{x['shared_reads']}, {x['shared_writes']})"
                                 for x in res["streams"]))
        print(line, flush=True)
        results[key] = res
    for B in envs:
        ins = [x[:, :B].contiguous() for x in blocks]
        rest = common.empty_outputs(s, B, ins[0].device)[2:]
        want = soa.physics_step_rows(s, n_substeps, *ins, phase_limit="fk", sink=True)
        for key, (record, knobs) in cases.items():
            def step(q_in, v_in, q_out, v_out, knobs=knobs):
                bl, outs = (q_in, v_in, *ins[2:]), (q_out, v_out, *rest)
                if knobs is None:
                    common.physics_probe(s, n_substeps, bl, outs, "fk", name=P.FK)
                else:
                    common.physics_probe_team(s, n_substeps, bl, outs, "fk", name=P.FK_TEAM,
                                              **knobs)

            got = common.empty_outputs(s, B, ins[0].device)
            step(*ins[:2], *got[:2])
            got[2:] = rest
            _, differing = common.compare_exact(got, want)
            if differing:
                raise AssertionError(f"P7 {key} at {B} envs: {differing} envs differ from the "
                                     "plain fk cut")
            us = common.carried_us(step, ins[:2], iters, runs)[1]
            res = results[key]
            res["us"][B] = us
            per_op = (f", {us * 1e3 / res['heaviest']:.3f} ns per heaviest-stream op"
                      if "heaviest" in res else
                      f", {us * 1e3 / build.last_build[record]['ops_per_env']:.3f} ns per op")
            print(f"P7 {' '.join(map(str, key)):12s} at {B:5d} envs: {us:9.2f} us per step "
                  f"(graph), bit for bit with the plain fk cut; "
                  f"{results[('one-thread',)]['us'][B] / us:.2f}x the one-thread cut{per_op}",
                  flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("K1", "K2", "K3", "K4", "P7"), default="K1")
    ap.add_argument("--warps", type=lambda t: tuple(int(x) for x in t.split(",")),
                    default=None, help="K4 and P7: the warps per block to sweep (default "
                    "K4_WARPS, P7_WARPS)")
    ap.add_argument("--rows", type=lambda t: tuple(int(x) for x in t.split(",")),
                    default=K4_ROWS, help="K4: the MLP outputs per thread to sweep")
    ap.add_argument("--caps", type=lambda t: tuple(int(x) for x in t.split(",")),
                    default=P7_CAPS, help="P7: the stage budgets to sweep")
    ap.add_argument("--envs", type=lambda t: tuple(int(x) for x in t.split(",")),
                    default=(4096, common.TILE), help="P7: the env counts to time at (multiples "
                    "of 128, at most 4096)")
    ap.add_argument("--variants", type=parse_variants, default=None,
                    help="comma-separated W:cap:cross:shared_kb[:sum_unroll] (default: "
                    "VARIANTS, or K3_VARIANTS for K3)")
    ap.add_argument("--trips", type=lambda t: tuple(int(x) for x in t.split(",")),
                    default=None, help="the line search's expand,Illinois trips (a timing "
                    "variant: another program than the production one)")
    args = ap.parse_args(argv)
    common.require_cuda("profile_team")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    if args.kernel == "K4":
        run_k4(*k4_inputs(device), warps=args.warps or K4_WARPS, rows=args.rows)
    elif args.kernel == "P7":
        s, n_substeps, model = common.nominal_setup(device)
        run_p7(s, n_substeps, common.nominal_blocks(s, model, max(args.envs), device),
               args.warps or P7_WARPS, args.caps, args.envs)
    elif args.kernel == "K3":
        env, L, blocks = k3_inputs(device)
        run(env._s, env._es, env._n_substeps, "K3", {blocks[0].shape[1]: blocks},
            args.variants or K3_VARIANTS, args.trips, episode_length=L)
    else:
        env, blocks = profile_layout.team_blocks(device)
        run(env._s, env._es, env._n_substeps, args.kernel, blocks[args.kernel],
            args.variants or VARIANTS, args.trips)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
