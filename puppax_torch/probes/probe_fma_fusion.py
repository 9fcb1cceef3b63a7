"""Does multiply-add contraction pay on the card, and what does it move?

    python -m puppax_torch.probes.probe_fma_fusion [--K 4000] [--envs 4096] [--k3]

The H100 counterpart of ``dev/probe_fma_fusion.py`` (``run`` :47,
``pallas_call`` :48), which compared K dependent ``y = y*a + b`` pairs with
2K dependent adds (and 2K multiplies) on one (8, 128) tile over a grid of
512, to see whether the TPU compiler fuses multiply-adds.

1. The chain (``csrc/probe_fma.cuh``): one dependent chain per element, K
   multiply-add pairs ("muladd"), 2K adds ("add2k") or 2K multiplies
   ("mul2k"), built under ``--fmad=false`` and ``--fmad=true``, in two
   designs timed in turns on the TPU's grid of 512 x 1024 elements: the
   redesign (``fma_chain``: ``ELEMENTS`` (8) interleaved elements per thread
   that share their b, the K loop unrolled by 16, a grid of the resident
   blocks; the card's limits there are instruction issue and operand
   reads) and one element per thread
   (``fma_chain_one_element``, the A/B baseline, 512 blocks x 1024
   threads). The one-element kernel also runs one 128-thread block per SM
   (K1's occupancy; a latency measurement). It prints each mode's time per
   launch, ns per operation over all elements and per dependent operation
   of one chain, the muladd / add2k ratio per design and flag (about 0.5 if
   the pairs contract and issue is the limit, about 1.0 if not), the
   dependent-latency floor (K x the FFMA latency over ``clocks.max.sm``),
   the issue floor (each FP32 instruction one issue slot of one of 132 x
   128 lanes per clock) at ``clocks.max.sm`` and at the ``clocks.sm`` read
   while the muladd chain runs, the resident blocks per SM and the grid of
   each design, and each build's SASS: its FFMA / FMUL / FADD count and the
   instruction mix of each loop (the FP32 operations per trip beside the
   loop's counter, compare and branch; how many FP32 sources the reuse
   cache serves). Every ``--fmad=false`` launch
   equals the plain torch loop bit for bit; the ``--fmad=true`` redesign
   equals the ``--fmad=true`` one-element kernel bit for bit in every mode
   whose pairs both builds' SASS shows as one FFMA each
   (``contracts_every_pair``; add2k and mul2k have no pairs), and its
   distance from the plain loop is printed.
2. K1's whole body under ``--fmad=true`` against the ``--fmad=false``
   build on the same states, in two designs: one thread per env
   (``csrc/probe_physics.cuh``; production K1 keeps ``--fmad=false``) and
   team K1's (``csrc/probe_physics_team.cuh``, production's schedule on 4
   warps): the change in time (windows of carried launches, false / true /
   true / false), how far q, v and the caches move (envs outside qpos 5e-5
   / scaled qvel 5e-4, at most ``MAX_OUTSIDE_ENVS``; the largest
   difference), each build's SASS FFMA / FMUL / FADD counts and ptxas's
   registers, stack and spills.
3. ``--k3``: the same for the one-thread K3 (the wrapped env step) on a
   DR'd reset of the default training configuration; ``chip_smoke.py``
   leaves it out to save one full build.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, Optional

import torch

from puppax_torch.kernels import build
from puppax_torch.probes import common

K_DEFAULT = 4000  # dev/probe_fma_fusion.py:30
TPU_GRID = (512, 1024)  # blocks, threads (elements of one (8, 128) tile)
MODES = ("muladd", "add2k", "mul2k")
# dependent FFMA latency in cycles on Volta to Hopper SMs (published
# microbenchmarks); the floor it gives is an estimate, printed as such
FFMA_LATENCY_CYCLES = 4
FP32_LANES_PER_SM = 128  # one FP32 instruction per lane per clock (Hopper SM)
CHAIN_REPS = 10  # launches per timed chain window
PER_SM_K_FACTOR = 10  # the per-SM grid's chain is this many times longer
K1_ITERS = 20  # carried launches per timed K1 window
# the redesign's interleaved elements per thread and threads per block
# (csrc/probe_fma.cuh's FMA_ILP_E, chosen on the card among 1, 2, 4 and 8,
# PERF.md; FMA_ILP_THREADS)
ELEMENTS = 8
ILP_THREADS = 256
K_UNROLL = 16  # the redesign's K loop is unrolled by this (FMA_ILP_UNROLL_K)
CLOCK_SECONDS = 1.0  # the muladd chain runs this long while clocks.sm is read
# K1 under --fmad=true: at most this many of the 4096 DR'd envs may move
# outside qpos 5e-5 / scaled qvel 5e-4 (chip_smoke.py's MAX_DIFFERING_ENVS)
MAX_OUTSIDE_ENVS = 4


def latency_grid(device) -> tuple:
    """One 128-thread block per SM: K1's occupancy."""
    return (torch.cuda.get_device_properties(device).multi_processor_count, 128)


def chain_inputs(n: int, device):
    """The TPU probe's tile values (:94-95): a = 1.0000001, b = 1e-7."""
    a = torch.full((n,), 1.0000001, dtype=torch.float32, device=device)
    b = torch.full((n,), 1e-7, dtype=torch.float32, device=device)
    return a, b


def chain_rows(a: torch.Tensor, b: torch.Tensor, K: int, mode: str, blocks: int):
    """The chain's plain version: the same dependent chain as torch ops on
    ``(blocks, n)``, each product and sum rounded apart."""
    g = torch.arange(blocks, dtype=torch.float32, device=a.device)[:, None]
    seeded = a[None, :] + g * torch.tensor(1e-9, dtype=torch.float32, device=a.device)
    y = seeded
    if mode == "muladd":
        for _ in range(K):
            y = y * seeded + b
    elif mode == "add2k":
        for _ in range(2 * K):
            y = y + b
    else:
        for _ in range(2 * K):
            y = y * seeded
    return y


def chain_name(fmad: bool, one_element: bool = False) -> str:
    """The launch name of a chain kernel: ``fma_chain`` (``fma_chain_fmad``)
    for the redesign, with ``[one-element]`` for the one-element-per-thread
    design."""
    name = "fma_chain_fmad" if fmad else "fma_chain"
    return name + ("[one-element]" if one_element else "")


def _check_chain(a, b, out, mode, blocks):
    n = a.shape[0]
    for x, shape in ((a, (n,)), (b, (n,)), (out, (blocks, n))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fma_chain: {x.dtype} {tuple(x.shape)}, expected float32 {shape}")
        if x.device != a.device:
            raise ValueError("fma_chain: the tensors lie on different devices")
    if mode not in MODES:
        raise ValueError(f"fma_chain: mode {mode!r} is not one of {MODES}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fma_chain: unsupported device {a.device}")
    return n


def fma_chain(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, K: int, mode: str,
              blocks: int, fmad: bool):
    """The chain of every element (block g, element i) of a ``blocks`` x n
    grid into ``out`` ``(blocks, n)``, through the redesign: ``ELEMENTS``
    interleaved elements per thread on a grid of the resident blocks.
    CPU tensors run the plain version (``chain_rows``); CUDA tensors launch
    the kernel built with or without contraction, or raise. Each launch
    counts in ``common.launches[chain_name(fmad)]``."""
    n = _check_chain(a, b, out, mode, blocks)
    if a.device.type == "cpu":
        out.copy_(chain_rows(a, b, K, mode, blocks))
        return
    lib = build.fma_chain_ilp_library(fmad)
    build.launch_into("fma_chain_ilp", lib.fma_chain_ilp_launch, [a, b, out], n, K,
                      MODES.index(mode), blocks)
    common.count_launch(chain_name(fmad))


def fma_chain_one_element(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, K: int,
                          mode: str, blocks: int, fmad: bool):
    """``fma_chain`` through the one-element-per-thread kernel (``blocks``
    blocks of n threads, n <= 1024), the A/B baseline. Each launch counts in
    ``common.launches[chain_name(fmad, one_element=True)]``."""
    n = _check_chain(a, b, out, mode, blocks)
    if a.device.type == "cpu":
        out.copy_(chain_rows(a, b, K, mode, blocks))
        return
    lib = build.fma_chain_library(fmad)
    build.launch_into("fma_chain", lib.fma_chain_launch, [a, b, out], n, K, MODES.index(mode),
                      blocks)
    common.count_launch(chain_name(fmad, one_element=True))


def build_all(s, n_substeps: int):
    """The chain's two designs and K1's whole body (one-thread and team
    K1's program) under both flags, at once; returns their
    ``build.last_build`` names."""
    builds = []
    for fmad in (False, True):
        builds += [lambda f=fmad: build.fma_chain_library(f),
                   lambda f=fmad: build.fma_chain_ilp_library(f),
                   lambda f=fmad: build.probe_physics_library(s, n_substeps, None, fmad=f),
                   lambda f=fmad: build.probe_physics_team_library(s, n_substeps, None, fmad=f)]
    build.build_in_parallel(*builds)
    return [build.record_name(k, v, build.probe_flags(f)) for f in (False, True)
            for k, v in ((build.FMA_CHAIN, ""), (build.FMA_CHAIN_ILP, ""),
                         (build.PROBE_PHYSICS, "full"), (build.PROBE_PHYSICS_TEAM, "full"))]


def issue_floor_us(instructions: int, elements: int, sms: int, mhz: float) -> float:
    """The least time of ``instructions`` FP32 instructions per element over
    ``elements`` elements at one instruction per lane per clock: 132 SMs x
    128 lanes x ``mhz``."""
    return instructions * elements / (sms * FP32_LANES_PER_SM * mhz)


def fp32_instructions(K: int, mode: str, fmad: bool) -> int:
    """FP32 instructions of one chain: K FFMA for a contracted muladd, else
    2K multiplies or adds."""
    return K if (mode == "muladd" and fmad) else 2 * K


def _sass_report(fmad: bool, design: str) -> Optional[dict]:
    """The SASS of one design's kernel function under one flag (None where
    the toolkit has no cuobjdump): its FFMA / FMUL / FADD count and the
    loops that hold FP32 work, each with its instruction mix, reads and
    whether it is innermost."""
    if design == "one-element":
        kernel, function = build.FMA_CHAIN, "fma_chain_kernel"
    else:
        kernel, function = build.FMA_CHAIN_ILP, "fma_chain_ilp_kernel"
    text = common.sass_text(build.record_name(kernel, "", build.probe_flags(fmad)), kernel)
    if text is None:
        return None
    return dict(counts=common.fp32_counts(text, function),
                loops=[{k: x[k] for k in ("instructions", "fp32", "other", "reads", "inner")}
                       for x in common.sass_loops(text, function) if x["fp32"]])


def contracts_every_pair(report: Optional[dict]) -> bool:
    """Whether a chain build's SASS (``_sass_report``) shows every
    multiply-add pair of its K loops as one FFMA: an innermost loop holds
    FFMA and none holds FMUL and FADD together (an uncontracted pair). The
    K loops are the innermost ones; at K a multiple of ``K_UNROLL`` the
    redesign's remainder code, outside them, does not run. False without
    SASS."""
    if report is None:
        return False
    inner = [x["fp32"] for x in report["loops"] if x["inner"]]
    return (any("FFMA" in f for f in inner)
            and not any("FMUL" in f and "FADD" in f for f in inner))


def run_chain(device, K: int = K_DEFAULT, reps: int = CHAIN_REPS, runs: int = common.RUNS,
              clock_seconds: float = CLOCK_SECONDS) -> Dict[tuple, dict]:
    """Time and check every (grid, mode, flag, design). The TPU grid runs K
    pairs in both designs, in turns (one-element, redesign, redesign,
    one-element); the per-SM grid runs the one-element kernel at
    ``PER_SM_K_FACTOR`` x K, so that its chain outlasts the gap between two
    launches. Raises if a ``--fmad=false`` launch differs from the plain
    loop, or the redesign from the one-element kernel under the same flag
    where both builds contract every pair (``contracts_every_pair``, K a
    multiple of ``K_UNROLL``; always under ``--fmad=false`` and in add2k and
    mul2k). Returns, per (grid
    name, mode, fmad, design) with design ``"one-element"`` or
    ``"redesign"``: ``K``, ``ms`` per launch (from one CUDA graph of
    ``reps`` launches: the device's time; the median of the two turns),
    ``eager_ms``, ``ns_per_op`` over all elements, ``ns_per_dep_op`` of one
    chain, ``max_abs_err`` against the plain loop, ``plain_ms``, the FP32
    ``instructions`` per chain and the ``issue_floor_us`` at
    ``clocks.max.sm``; for the TPU grid's muladd also ``clocks_sm`` (the
    MHz samples read while it runs) and ``issue_floor_measured_us`` at
    their median; the redesign's ``vs_one_element`` (max abs err, differing
    elements against the one-element kernel under the same flag) and
    ``exact`` (whether that comparison was held bit for bit). Per (grid
    name, "ratio", fmad, design) the muladd / add2k ratio; per (grid name,
    "floor_us") the dependent-latency floor of K FFMAs; per ("sass", fmad)
    each design's ``_sass_report``; per ("contracted", fmad) each design's
    ``contracts_every_pair``; ("occupancy",) the resident blocks per SM and
    the grid."""
    print(common.nvidia_smi(), flush=True)
    clock_mhz = float(common.nvidia_smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    build.build_in_parallel(*[(lambda f=f, lib=lib: lib(f)) for f in (False, True)
                              for lib in (build.fma_chain_library, build.fma_chain_ilp_library)])
    libs = {fmad: build.fma_chain_ilp_library(fmad) for fmad in (False, True)}
    blocks_tpu, n_tpu = TPU_GRID
    occupancy = dict(one_element_per_sm=libs[False].fma_chain_occupancy(0, n_tpu),
                     redesign_per_sm=libs[False].fma_chain_occupancy(1, ILP_THREADS),
                     redesign_grid=libs[False].fma_chain_ilp_grid(n_tpu, blocks_tpu))
    results = {("occupancy",): occupancy}
    print(f"chain occupancy on {sms} SMs: the one-element kernel {occupancy['one_element_per_sm']} "
          f"blocks of {n_tpu} threads per SM ({blocks_tpu} blocks: "
          f"{blocks_tpu / (sms * max(occupancy['one_element_per_sm'], 1)):.2f} waves); the "
          f"redesign ({ELEMENTS} elements per thread), {occupancy['redesign_per_sm']} blocks of "
          f"{ILP_THREADS} threads per SM, grid {occupancy['redesign_grid']}", flush=True)
    designs = ["one-element", "redesign"]
    for fmad in (False, True):
        results[("sass", fmad)] = {d: _sass_report(fmad, d) for d in designs}
        results[("contracted", fmad)] = {d: contracts_every_pair(x)
                                         for d, x in results[("sass", fmad)].items()}
        for d, x in results[("sass", fmad)].items():
            head = f"chain --fmad={str(fmad).lower()} {d} SASS:"
            if x is None:
                print(f"{head} no cuobjdump", flush=True)
                continue
            print(f"{head} {x['counts']}; every pair one FFMA: "
                  f"{results[('contracted', fmad)][d]}; loops " + "; ".join(
                      f"{l['instructions']} instructions{' (innermost)' if l['inner'] else ''} "
                      f"({l['fp32']} beside {l['other']}; FP32 reads {l['reads']})"
                      for l in x["loops"]), flush=True)
    both_contract = all(results[("contracted", True)].values()) and K % K_UNROLL == 0

    def launch(design, a, b, out, k, mode, blocks, fmad):
        if design == "one-element":
            fma_chain_one_element(a, b, out, k, mode, blocks, fmad)
        else:
            fma_chain(a, b, out, k, mode, blocks, fmad)

    for grid_name, (blocks, n), k, grid_designs in (
            ("tpu", TPU_GRID, K, designs),
            ("per-sm", latency_grid(device), PER_SM_K_FACTOR * K, ["one-element"])):
        a, b = chain_inputs(n, device)
        print(f"chain, K={k}, grid {blocks} blocks x {n} elements ({grid_name}; CUDA events); "
              f"per launch from one CUDA graph of {reps} launches (the device's time), eager "
              f"beside; designs {grid_designs} in turns:", flush=True)
        for mode in MODES:
            plain = []
            plain_ms = common.window_ms(lambda: plain.append(chain_rows(a, b, k, mode, blocks)))
            for fmad in (False, True):
                outs, windows = {}, {}
                for d in grid_designs:
                    out = torch.empty((blocks, n), dtype=torch.float32, device=device)
                    launch(d, a, b, out, k, mode, blocks, fmad)  # held against the plain loop
                    outs[d] = out
                    if not bool(torch.isfinite(out).all()):
                        raise AssertionError(f"chain {mode} {d} fmad={fmad}: non-finite outputs")

                    def window(d=d, out=out, mode=mode, fmad=fmad):
                        for _ in range(reps):
                            launch(d, a, b, out, k, mode, blocks, fmad)

                    windows[d] = window
                times = {d: [] for d in grid_designs}
                order = grid_designs + grid_designs[::-1]
                for d in order:
                    times[d].append(common.eager_and_graph_ms(windows[d], runs))
                for d in grid_designs:
                    err, differing = common.compare_exact([outs[d].reshape(1, -1)],
                                                          [plain[0].reshape(1, -1)])
                    if differing and not fmad:
                        raise AssertionError(f"chain {mode} {d} --fmad=false: "
                                             f"{differing} elements differ from the plain loop")
                    eager = statistics.median(e for e, _ in times[d]) / reps
                    ms = statistics.median(g for _, g in times[d]) / reps
                    ops, instrs = 2 * k, fp32_instructions(k, mode, fmad)
                    res = dict(K=k, ms=ms, eager_ms=eager, ns_per_op=ms * 1e6 / (ops * blocks * n),
                               ns_per_dep_op=ms * 1e6 / ops, max_abs_err=err, differing=differing,
                               plain_ms=plain_ms, instructions=instrs,
                               issue_floor_us=issue_floor_us(instrs, blocks * n, sms, clock_mhz))
                    vs = ""
                    if d != "one-element":
                        res["vs_one_element"] = common.compare_exact(
                            [outs[d].reshape(1, -1)], [outs["one-element"].reshape(1, -1)])
                        res["exact"] = not fmad or mode != "muladd" or both_contract
                        if res["vs_one_element"][1] and res["exact"]:
                            raise AssertionError(
                                f"chain {mode} {d} --fmad={str(fmad).lower()}: "
                                f"{res['vs_one_element'][1]} elements differ from the one-element "
                                f"kernel, which must match bit for bit")
                        held = ("held bit for bit" if res["exact"]
                                else "not held: uncontracted pairs or no SASS")
                        vs = (f"; vs one-element: max abs err {res['vs_one_element'][0]!r} "
                              f"({res['vs_one_element'][1]} differ; {held})")
                    if grid_name == "tpu" and mode == "muladd":
                        samples = common.clock_under_load(windows[d], clock_seconds)
                        res["clocks_sm"] = samples
                        res["issue_floor_measured_us"] = issue_floor_us(
                            instrs, blocks * n, sms, statistics.median(samples))
                        vs += (f"; clocks.sm under load {statistics.median(samples):.0f} MHz "
                               f"(samples {min(samples):.0f}-{max(samples):.0f}), issue floor "
                               f"{res['issue_floor_measured_us']:.2f} us there")
                    results[(grid_name, mode, fmad, d)] = res
                    print(f"  {mode:6s} --fmad={str(fmad).lower():5s} {d:11s}: "
                          f"{ms * 1e3:9.2f} us per launch (eager {eager * 1e3:9.2f}), "
                          f"{res['ns_per_op']:.6f} ns per op (all elements), "
                          f"{res['ns_per_dep_op']:.4f} ns per dependent op of one chain; issue "
                          f"floor {res['issue_floor_us']:.2f} us at clocks.max.sm "
                          f"({100 * res['issue_floor_us'] / (ms * 1e3):.1f} % of it); vs plain: "
                          f"max abs err {err!r} ({differing} of {blocks * n} differ); plain "
                          f"{plain_ms:.1f} ms{vs}", flush=True)
        for d in grid_designs:
            for fmad in (False, True):
                ratio = (results[(grid_name, "muladd", fmad, d)]["ms"]
                         / results[(grid_name, "add2k", fmad, d)]["ms"])
                results[(grid_name, "ratio", fmad, d)] = ratio
                print(f"  {grid_name} {d} --fmad={str(fmad).lower()}: muladd / add2k = "
                      f"{ratio:.3f} (~0.5: the pairs contract and issue bounds; ~1.0: they do "
                      f"not)", flush=True)
        floor = k * FFMA_LATENCY_CYCLES / clock_mhz
        print(f"  dependent-latency floor at clocks.max.sm {clock_mhz:.0f} MHz, "
              f"{FFMA_LATENCY_CYCLES} cycles per FFMA (estimate): K x latency "
              f"{floor:.2f} us, 2K x latency {2 * floor:.2f} us", flush=True)
        results[(grid_name, "floor_us")] = floor
    return results


def movement(s, got, want) -> dict:
    """How far K1's outputs (q, v, caches; the probe's sink row aside) under
    contraction move from the build without it: the largest difference per
    block, and the envs outside qpos 5e-5 / qvel 5e-4 scaled by max(1, the
    env's largest |qvel|)."""
    dq, dv, dc = [(g - w).abs() for g, w in zip(got[:3], want[:3])]
    scale = want[1].abs().amax(0).clamp_min(1.0)
    outside = (dq > 5e-5).any(0) | ((dv / scale) > 5e-4).any(0)
    return dict(max_q=float(dq.max()), max_v=float(dv.max()), max_caches=float(dc.max()),
                outside=int(outside.sum()), differing=int(((dq > 0).any(0) | (dv > 0).any(0)
                                                           | (dc > 0).any(0)).sum()))


def k1_fmad_outputs(s, n_substeps: int, blocks, team: bool,
                    max_outside: int = MAX_OUTSIDE_ENVS):
    """K1's whole body (team or one-thread) built with and without
    contraction, one launch each on ``blocks``: (outputs by flag,
    ``movement``). Raises if the contracted build's outputs are not finite
    or more than ``max_outside`` envs move outside the tolerance."""
    B, dev = blocks[0].shape[1], blocks[0].device
    probe = common.physics_probe_team if team else common.physics_probe
    tile = common.TEAM_TILE if team else common.TILE
    design = "team" if team else "one-thread"
    outs = {}
    for fmad in (False, True):
        outs[fmad] = common.empty_outputs(s, B, dev, tile=tile)
        probe(s, n_substeps, blocks, outs[fmad], None, fmad=fmad)
    for name, x in zip(("q", "v", "caches", "sink"), outs[True]):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"K1 ({design}) --fmad=true: non-finite {name}")
    moved = movement(s, outs[True], outs[False])
    if moved["outside"] > max_outside:
        raise AssertionError(f"K1 ({design}) --fmad=true: {moved['outside']} of {B} envs outside "
                             f"qpos 5e-5 / scaled qvel 5e-4 (limit {max_outside})")
    return outs, moved


def _k1_half(s, n_substeps: int, blocks, iters: int, team: bool, max_outside: int) -> dict:
    """One design of K1 (team or one-thread) under ``--fmad=true`` against
    ``--fmad=false`` on ``blocks``: see ``run_k1``."""
    q, v, ctrl, dr = blocks
    B = q.shape[1]
    probe = common.physics_probe_team if team else common.physics_probe
    kernel = build.PROBE_PHYSICS_TEAM if team else build.PROBE_PHYSICS
    outs, moved = k1_fmad_outputs(s, n_substeps, blocks, team, max_outside)

    def timed(fmad):
        def step(q_in, v_in, q_out, v_out):
            probe(s, n_substeps, (q_in, v_in, ctrl, dr), (q_out, v_out, *outs[fmad][2:]), None,
                  fmad=fmad)
        return common.carried_us(step, (q, v), iters, runs=1)[1] / 1e3

    ms = {False: [], True: []}
    for fmad in (False, True, True, False):
        ms[fmad].append(timed(fmad))
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    sass, ptxas = {}, {}
    for fmad in (False, True):
        record = build.record_name(kernel, "full", build.probe_flags(fmad))
        sass[fmad] = common.sass_counts(record, kernel)
        ptxas[fmad] = common.ptxas_info(record)
    design = "team K1 (4 warps)" if team else "one-thread K1"
    print(f"{design} at {B} envs: --fmad=false {off:.4f} ms (runs {ms[False]}), --fmad=true "
          f"{on:.4f} ms (runs {ms[True]}), change {100 * (on / off - 1):+.1f} %; outputs moved: "
          f"{moved['differing']} envs differ at all, {moved['outside']} outside qpos 5e-5 / "
          f"scaled qvel 5e-4, largest difference q {moved['max_q']!r} v {moved['max_v']!r} "
          f"caches {moved['max_caches']!r}; SASS --fmad=false {sass[False]}, --fmad=true "
          f"{sass[True]}; ptxas --fmad=false {ptxas[False]}, --fmad=true {ptxas[True]}",
          flush=True)
    return dict(ms_off=off, ms_on=on, runs=ms, sass=sass, ptxas=ptxas, **moved)


def run_k1(s, n_substeps: int, blocks, iters: int = K1_ITERS,
           max_outside: int = MAX_OUTSIDE_ENVS) -> dict:
    """K1's whole body under ``--fmad=true`` against ``--fmad=false`` on
    ``blocks``, one thread per env and in team K1's design: ``ms_off`` and
    ``ms_on`` per step of each build (the device's time, from one CUDA
    graph of ``iters`` carried launches; median of two windows, taken
    false / true / true / false), ``movement``'s keys, each build's FFMA /
    FMUL / FADD count (``sass``) and ptxas's numbers (``ptxas``); the team
    design's under ``"team"``. The contracted builds' outputs must be
    finite, with at most ``max_outside`` envs outside the tolerance
    (``k1_fmad_outputs``)."""
    res = _k1_half(s, n_substeps, blocks, iters, False, max_outside)
    res["team"] = _k1_half(s, n_substeps, blocks, iters, True, max_outside)
    return res


def run_k3(device, seed: int = 0) -> dict:
    """The one-thread K3 under ``--fmad=true`` against its production
    ``--fmad=false`` build, on one wrapped step of a DR'd reset of the
    default training configuration (``profile_team.k3_inputs``)."""
    from puppax_torch.env import soa_env
    from puppax_torch.probes import profile_team

    env, L, blocks = profile_team.k3_inputs(device, seed=seed)
    s, es, n_sub, B = env._s, env._es, env._n_substeps, blocks[0].shape[1]
    libs = build.build_in_parallel(
        lambda: build.wrapped_step_library(s, es, n_sub, L),
        lambda: build.wrapped_step_fmad_library(s, es, n_sub, L))
    _, out_rows = soa_env.block_rows(s, es)
    outs = {fmad: build.launch("wrapped_step", lib.wrapped_step_launch, blocks, out_rows, B,
                               device) for fmad, lib in zip((False, True), libs)}
    dq, dv = [(outs[True][i] - outs[False][i]).abs() for i in (0, 1)]
    scale = outs[False][1].abs().amax(0).clamp_min(1.0)
    outside = int(((dq > 5e-5).any(0) | ((dv / scale) > 5e-4).any(0)).sum())
    ms = {False: [], True: []}
    for fmad in (False, True, True, False):
        lib = libs[int(fmad)]
        ms[fmad].append(common.best_ms(lambda: [build.launch(
            "wrapped_step", lib.wrapped_step_launch, blocks, out_rows, B, device)
            for _ in range(K1_ITERS)], runs=1) / K1_ITERS)
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    print(f"K3 at {B} envs: --fmad=false {off:.4f} ms, --fmad=true {on:.4f} ms, change "
          f"{100 * (on / off - 1):+.1f} %; {outside} envs outside qpos 5e-5 / scaled qvel 5e-4, "
          f"largest difference q {float(dq.max())!r} v {float(dv.max())!r}", flush=True)
    return dict(ms_off=off, ms_on=on, outside=outside)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--K", type=int, default=K_DEFAULT)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--k3", action="store_true", help="also time K3 under --fmad=true")
    args = ap.parse_args(argv)
    common.require_cuda("probe_fma_fusion")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    s, n_substeps, model = common.nominal_setup(device)
    common.print_builds(build_all(s, n_substeps))
    run_chain(device, args.K)
    run_k1(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    if args.k3:
        run_k3(device)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
