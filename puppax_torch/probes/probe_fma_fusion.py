"""Does multiply-add contraction pay on the card, and what does it move?

    python -m puppax_torch.probes.probe_fma_fusion [--K 4000] [--envs 4096] [--k3]

The H100 counterpart of ``dev/probe_fma_fusion.py`` (``run`` :47,
``pallas_call`` :48), which compared K dependent ``y = y*a + b`` pairs with
2K dependent adds (and 2K multiplies) on one (8, 128) tile over a grid of
512, to see whether the TPU compiler fuses multiply-adds.

1. The chain (``csrc/probe_fma.cuh``): one dependent chain per thread, K
   multiply-add pairs ("muladd"), 2K adds ("add2k") or 2K multiplies
   ("mul2k"), built under ``--fmad=false`` and ``--fmad=true``, at two
   grids: the TPU's 512 blocks x 1024 elements (throughput-bound) and one
   128-thread block per SM (K1's occupancy; latency-bound). It prints each
   mode's time per launch, ns per operation over all threads and per
   dependent operation of one thread, the muladd / add2k ratio per flag
   (about 0.5 if the pairs contract, about 1.0 if not) and the
   dependent-latency floor (K x the FFMA latency over ``clocks.max.sm``).
   The ``--fmad=false`` build equals the plain torch loop bit for bit; the
   ``--fmad=true`` build's distance from it is printed.
2. K1's whole body under ``--fmad=true`` in the probe shell (a probe-only
   library; production K1 keeps ``--fmad=false``) against the
   ``--fmad=false`` build on the same states: the change in time (windows
   of carried launches, false / true / true / false) and how far q, v and
   the caches move (envs outside qpos 5e-5 / scaled qvel 5e-4, the largest
   difference).
3. ``--k3``: the same for the one-thread K3 (the wrapped env step) on a
   DR'd reset of the default training configuration; ``chip_smoke.py``
   leaves it out to save one full build.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict

import torch

from puppax_torch.kernels import build
from puppax_torch.probes import common

K_DEFAULT = 4000  # dev/probe_fma_fusion.py:30
TPU_GRID = (512, 1024)  # blocks, threads (elements of one (8, 128) tile)
MODES = ("muladd", "add2k", "mul2k")
# dependent FFMA latency in cycles on Volta to Hopper SMs (published
# microbenchmarks); the floor it gives is an estimate, printed as such
FFMA_LATENCY_CYCLES = 4
CHAIN_REPS = 10  # launches per timed chain window
PER_SM_K_FACTOR = 10  # the per-SM grid's chain is this many times longer
K1_ITERS = 20  # carried launches per timed K1 window


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


def fma_chain(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, K: int, mode: str,
              blocks: int, fmad: bool):
    """The chain of every (block, thread) into ``out`` ``(blocks, n)``.
    CPU tensors run the plain version (``chain_rows``); CUDA tensors launch
    the kernel built with or without contraction, or raise. Each launch
    counts in ``common.launches["fma_chain"]`` (or ``"fma_chain_fmad"``)."""
    n = a.shape[0]
    for x, shape in ((a, (n,)), (b, (n,)), (out, (blocks, n))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fma_chain: {x.dtype} {tuple(x.shape)}, expected float32 {shape}")
        if x.device != a.device:
            raise ValueError("fma_chain: the tensors lie on different devices")
    if mode not in MODES:
        raise ValueError(f"fma_chain: mode {mode!r} is not one of {MODES}")
    if a.device.type == "cpu":
        out.copy_(chain_rows(a, b, K, mode, blocks))
        return
    if a.device.type != "cuda":
        raise ValueError(f"fma_chain: unsupported device {a.device}")
    lib = build.fma_chain_library(fmad)
    build.launch_into("fma_chain", lib.fma_chain_launch, [a, b, out], n, K, MODES.index(mode),
                      blocks)
    common.count_launch("fma_chain_fmad" if fmad else "fma_chain")


def build_all(s, n_substeps: int):
    """Both chain builds and K1's whole body under both flags, at once;
    returns their ``build.last_build`` names."""
    build.build_in_parallel(
        lambda: build.fma_chain_library(False), lambda: build.fma_chain_library(True),
        lambda: build.probe_physics_library(s, n_substeps, None, fmad=False),
        lambda: build.probe_physics_library(s, n_substeps, None, fmad=True))
    return [build.record_name(build.FMA_CHAIN), build.record_name(build.FMA_CHAIN, "",
                                                                   build.probe_flags(True)),
            build.record_name(build.PROBE_PHYSICS, "full"),
            build.record_name(build.PROBE_PHYSICS, "full", build.probe_flags(True))]


def run_chain(device, K: int = K_DEFAULT, reps: int = CHAIN_REPS,
              runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Time and check every (grid, mode, flag). The TPU grid runs K pairs,
    the per-SM grid ``PER_SM_K_FACTOR`` x K, so that its chain outlasts the
    gap between two launches. Returns, per (grid name, mode, fmad): ``K``,
    ``ms`` per launch (from one CUDA graph of ``reps`` launches: the
    device's time), ``eager_ms``, ``ns_per_op`` over all threads,
    ``ns_per_dep_op`` of one thread's chain, ``max_abs_err`` against the
    plain loop and ``plain_ms``; per (grid name, "ratio", fmad) the muladd
    / add2k ratio; per (grid name, "floor_us") the dependent-latency floor
    of K FFMAs; per ("sass", fmad) the build's FFMA / FMUL / FADD count."""
    print(common.nvidia_smi(), flush=True)
    clock_mhz = float(common.nvidia_smi("clocks.max.sm", units=False))
    results = {}
    for grid_name, (blocks, n), k in (("tpu", TPU_GRID, K),
                                     ("per-sm", latency_grid(device), PER_SM_K_FACTOR * K)):
        a, b = chain_inputs(n, device)
        print(f"chain, K={k}, grid {blocks} blocks x {n} threads ({grid_name}; CUDA events); "
              f"per launch from one CUDA graph of {reps} launches (the device's time), eager "
              f"beside:", flush=True)
        for mode in MODES:
            plain = []
            plain_ms = common.window_ms(lambda: plain.append(chain_rows(a, b, k, mode, blocks)))
            for fmad in (False, True):
                out = torch.empty((blocks, n), dtype=torch.float32, device=device)
                fma_chain(a, b, out, k, mode, blocks, fmad)  # held against the plain loop
                err, differing = common.compare_exact([out.reshape(1, -1)],
                                                      [plain[0].reshape(1, -1)])
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"chain {mode} fmad={fmad}: non-finite outputs")
                if differing and not fmad:
                    raise AssertionError(f"chain {mode} --fmad=false: {differing} threads "
                                         f"differ from the plain loop")

                def window(mode=mode, fmad=fmad, out=out):
                    for _ in range(reps):
                        fma_chain(a, b, out, k, mode, blocks, fmad)

                eager, graph = common.eager_and_graph_ms(window, runs)
                ms = graph / reps
                ops = 2 * k
                results[(grid_name, mode, fmad)] = dict(
                    K=k, ms=ms, eager_ms=eager / reps, ns_per_op=ms * 1e6 / (ops * blocks * n),
                    ns_per_dep_op=ms * 1e6 / ops, max_abs_err=err, plain_ms=plain_ms)
                print(f"  {mode:6s} --fmad={str(fmad).lower():5s}: {ms * 1e3:9.2f} us per launch "
                      f"(eager {eager / reps * 1e3:9.2f}), {ms * 1e6 / (ops * blocks * n):.6f} ns "
                      f"per op (all threads), {ms * 1e6 / ops:.4f} ns per dependent op of one "
                      f"thread; vs plain: max abs err {err!r} ({differing} of {blocks * n} "
                      f"differ); plain {plain_ms:.1f} ms", flush=True)
        for fmad in (False, True):
            ratio = (results[(grid_name, "muladd", fmad)]["ms"]
                     / results[(grid_name, "add2k", fmad)]["ms"])
            results[(grid_name, "ratio", fmad)] = ratio
            print(f"  {grid_name} --fmad={str(fmad).lower()}: muladd / add2k = {ratio:.3f} "
                  f"(~0.5: the pairs contract; ~1.0: they do not)", flush=True)
        floor = k * FFMA_LATENCY_CYCLES / clock_mhz
        print(f"  dependent-latency floor at clocks.max.sm {clock_mhz:.0f} MHz, "
              f"{FFMA_LATENCY_CYCLES} cycles per FFMA (estimate): K x latency "
              f"{floor:.2f} us, 2K x latency {2 * floor:.2f} us", flush=True)
        results[(grid_name, "floor_us")] = floor
    for fmad in (False, True):
        record = build.record_name(build.FMA_CHAIN, "", build.probe_flags(fmad))
        results[("sass", fmad)] = common.sass_counts(record, build.FMA_CHAIN)
        print(f"chain --fmad={str(fmad).lower()} SASS: {results[('sass', fmad)]}", flush=True)
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


def run_k1(s, n_substeps: int, blocks, iters: int = K1_ITERS) -> dict:
    """K1's whole body under ``--fmad=true`` against ``--fmad=false`` on
    ``blocks``: ``ms`` per step of each (the device's time, from one CUDA
    graph of ``iters`` carried launches; median of two windows, taken
    false / true / true / false), the change, ``movement``, and on the card
    each build's FFMA / FMUL / FADD count. The contracted build's outputs
    must be finite."""
    q, v, ctrl, dr = blocks
    B, dev = q.shape[1], q.device
    outs = {}
    for fmad in (False, True):
        outs[fmad] = common.empty_outputs(s, B, dev)
        common.physics_probe(s, n_substeps, blocks, outs[fmad], None, fmad=fmad)
    for name, x in zip(("q", "v", "caches", "sink"), outs[True]):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"K1 --fmad=true: non-finite {name}")
    moved = movement(s, outs[True], outs[False])

    def timed(fmad):
        def step(q_in, v_in, q_out, v_out):
            common.physics_probe(s, n_substeps, (q_in, v_in, ctrl, dr),
                                 (q_out, v_out, *outs[fmad][2:]), None, fmad=fmad)
        return common.carried_us(step, (q, v), iters, runs=1)[1] / 1e3

    ms = {False: [], True: []}
    for fmad in (False, True, True, False):
        ms[fmad].append(timed(fmad))
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    sass = {}
    for fmad in (False, True):
        record = build.record_name(build.PROBE_PHYSICS, "full", build.probe_flags(fmad))
        sass[fmad] = common.sass_counts(record, build.PROBE_PHYSICS)
    print(f"K1 at {B} envs: --fmad=false {off:.4f} ms (runs {ms[False]}), --fmad=true "
          f"{on:.4f} ms (runs {ms[True]}), change {100 * (on / off - 1):+.1f} %; outputs moved: "
          f"{moved['differing']} envs differ at all, {moved['outside']} outside qpos 5e-5 / "
          f"scaled qvel 5e-4, largest difference q {moved['max_q']!r} v {moved['max_v']!r} "
          f"caches {moved['max_caches']!r}; SASS --fmad=false {sass.get(False)}, --fmad=true "
          f"{sass.get(True)}", flush=True)
    return dict(ms_off=off, ms_on=on, sass=sass, **moved)


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
