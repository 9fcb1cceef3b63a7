"""Does the grid shape or the block layout set K1's time on the card?

    python -m puppax_torch.probes.profile_layout [--envs 4096]

The H100 counterpart of ``dev/profile_layout.py`` (``kcall`` :113,
``pallas_call`` :114), which timed the fk-only and the full K1 in the
row-major ``(rows, B/128, 128)`` and the tile-major ``(nb, rows, 8, 128)``
block layouts. Here K1's body, cut after fk and whole, runs in the probe
shell ``csrc/probe_physics.cuh`` in the port's row-major ``(rows, B)``
layout and in a block-major ``(B/128, rows, 128)`` layout (one contiguous
tile of every block per 128 envs), each at 32, 64 and 128 threads per
block: 12 timings from 2 libraries (the phase probe's fk and full builds).
Each is timed as 50 back-to-back launches with q and v carried
(best of 3 windows, CUDA events), replayed from one CUDA graph (the
device's time) and eagerly. Every configuration's first launch,
converted back to row-major, must equal the row-major 128-thread one bit
for bit (which the phase probe holds against the plain version).

``run_team`` asks the same of the production K1's design: team K1's
program cut after fk and whole (``csrc/probe_physics_team.cuh``, 4 warps,
32 envs per block) in row-major ``(rows, B)`` and in block-major
``(B/32, rows, 32)`` (one contiguous tile per block), timed the same way
in turns (row-major, block-major, block-major, row-major; the better of
each pair). Each block-major launch, converted back, must equal the
row-major one bit for bit. The command line runs both designs.

The question on the H100: at 4096 envs K1's 32 blocks of 128 threads fill
32 of the 132 SMs, and one block alone took ~1.29 ms against ~1.7 ms for
all 32 on an NVIDIA H100 80GB HBM3 (``chip_smoke.py``, PERF.md). Smaller blocks spread the same envs over more SMs (128 blocks of 32
threads); the block-major layout makes each tile's rows contiguous.

Inputs as ``profile_kernel_phases``: the TPU probe's nominal states by
default; ``run`` takes any ``(rows, B)`` blocks.

    python -m puppax_torch.probes.profile_layout --team

asks the block-shape question of the team kernels (``csrc/physics_step_team.cuh``,
``csrc/env_step_team.cuh``: 32 envs per block, each env's program split
across the block's W warps by ``kernels/team.py``): team K1 and team K2 at
W = 4, 6, 8 and 16 warps per block, at 4096 and 128 envs, beside the
one-thread K1 and K2 (10 libraries built at once). Each launch is held bit
for bit against the one-thread kernel's; each time is the best of 3
windows of 20 launches on the same inputs (CUDA events), with the build's
registers, spills and shared memory. K1 runs on the nominal states above,
K2 on a nominal reset of the default env (zero actions and noise).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from puppax_torch import random
from puppax_torch.kernels import build
from puppax_torch.probes import common, profile_kernel_phases
from puppax_torch.probes.common import BLOCK_MAJOR, ROW_MAJOR, from_block_major, to_block_major

PHASES = ("fk", None)
THREADS = (32, 64, 128)


def build_all(s, n_substeps: int):
    """The four libraries (fk cut and full body, one-thread and team);
    returns their ``build.last_build`` names."""
    return profile_kernel_phases.build_all(s, n_substeps, PHASES)


def run(s, n_substeps: int, blocks, phases: Sequence[Optional[str]] = PHASES,
        threads: Sequence[int] = THREADS, iters: int = common.ITERS,
        runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Time every (cut, layout, threads) on ``blocks`` (q, v, ctrl, dr as
    ``(rows, B)``, B a multiple of 128). Returns, per (cut, layout,
    threads): ``us`` per step and ``max_abs_err`` against the row-major
    128-thread launch (0.0: they are held bit for bit)."""
    B, dev = blocks[0].shape[1], blocks[0].device
    print(common.nvidia_smi(), flush=True)
    print(f"K1 by layout and threads per block, {B} envs, {iters} launches per window with q "
          f"and v carried, best of {runs} windows (CUDA events); us/step from one CUDA graph "
          f"of the window (the device's time), eager beside:", flush=True)
    results = {}
    for cut in phases:
        ref = common.empty_outputs(s, B, dev)
        common.physics_probe(s, n_substeps, blocks, ref, cut)
        for layout in (ROW_MAJOR, BLOCK_MAJOR):
            lb = list(blocks) if layout == ROW_MAJOR else [to_block_major(x) for x in blocks]
            for t in threads:
                outs = common.empty_outputs(s, B, dev, layout)
                common.physics_probe(s, n_substeps, lb, outs, cut, layout, t)
                got = outs if layout == ROW_MAJOR else [from_block_major(x) for x in outs]
                err, differing = common.compare_exact(got, ref)
                if differing:
                    raise AssertionError(
                        f"K1 {cut or 'full'} {common.LAYOUT_NAMES[layout]} at {t} threads: "
                        f"{differing} envs differ from row-major at 128 threads")

                def step(q_in, v_in, q_out, v_out, cut=cut, layout=layout, t=t, lb=lb,
                         rest=outs[2:]):
                    common.physics_probe(s, n_substeps, (q_in, v_in, lb[2], lb[3]),
                                         (q_out, v_out, *rest), cut, layout, t)

                times = common.carried_us(step, lb[:2], iters, runs)
                us = times[1]
                results[(cut, layout, t)] = dict(us=us, eager_us=times[0], max_abs_err=err)
                print(f"{common.LAYOUT_NAMES[layout]:11s} {cut or 'full':4s} {t:3d} threads "
                      f"({B // t} blocks): {us:10.1f} us/step, {B / us:8.3f} M env-steps/s; "
                      f"eager {times[0]:10.1f} us/step", flush=True)
        for t in threads:
            ratio = results[(cut, BLOCK_MAJOR, t)]["us"] / results[(cut, ROW_MAJOR, t)]["us"]
            print(f"{cut or 'full'} at {t} threads: block-major / row-major {ratio:.3f}",
                  flush=True)
    return results


def run_team(s, n_substeps: int, blocks, phases: Sequence[Optional[str]] = PHASES,
             iters: int = common.ITERS, runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Time team K1's cuts (``common.physics_probe_team``) in both layouts
    on ``blocks`` (q, v, ctrl, dr as ``(rows, B)``, B a multiple of 32), in
    turns. Returns, per (cut, layout): ``us`` per step, ``eager_us`` and
    ``max_abs_err`` against the row-major launch (0.0: they are held bit
    for bit)."""
    B, dev = blocks[0].shape[1], blocks[0].device
    tile = common.TEAM_TILE
    print(common.nvidia_smi(), flush=True)
    print(f"team K1 cuts by layout ({build.TEAM_WARPS['physics_step_team']} warps, {tile} envs "
          f"per block), {B} envs, {iters} launches per window with q and v carried, best of "
          f"{runs} windows (CUDA events), the layouts in turns; us/step from one CUDA graph of "
          f"the window (the device's time), eager beside:", flush=True)
    results = {}
    for cut in phases:
        ref = common.empty_outputs(s, B, dev)
        common.physics_probe_team(s, n_substeps, blocks, ref, cut)
        steps = {}
        for layout in (ROW_MAJOR, BLOCK_MAJOR):
            lb = list(blocks) if layout == ROW_MAJOR else [to_block_major(x, tile) for x in blocks]
            outs = common.empty_outputs(s, B, dev, layout, tile)
            common.physics_probe_team(s, n_substeps, lb, outs, cut, layout)
            got = outs if layout == ROW_MAJOR else [from_block_major(x) for x in outs]
            err, differing = common.compare_exact(got, ref)
            if differing:
                raise AssertionError(f"team K1 {cut or 'full'} {common.LAYOUT_NAMES[layout]}: "
                                     f"{differing} envs differ from row-major")
            results[(cut, layout)] = dict(max_abs_err=err, us=float("inf"))

            def step(q_in, v_in, q_out, v_out, cut=cut, layout=layout, lb=lb, rest=outs[2:]):
                common.physics_probe_team(s, n_substeps, (q_in, v_in, lb[2], lb[3]),
                                          (q_out, v_out, *rest), cut, layout)

            steps[layout] = (step, lb[:2])
        for layout in (ROW_MAJOR, BLOCK_MAJOR, BLOCK_MAJOR, ROW_MAJOR):  # in turns
            eager, us = common.carried_us(*steps[layout], iters, runs)
            if us < results[(cut, layout)]["us"]:
                results[(cut, layout)].update(us=us, eager_us=eager)
        for layout in (ROW_MAJOR, BLOCK_MAJOR):
            r = results[(cut, layout)]
            print(f"team {common.LAYOUT_NAMES[layout]:11s} {cut or 'full':4s} ({-(-B // tile)} "
                  f"blocks): {r['us']:10.1f} us/step, {B / r['us']:8.3f} M env-steps/s; eager "
                  f"{r['eager_us']:10.1f} us/step; vs row-major: max abs err "
                  f"{r['max_abs_err']!r}", flush=True)
        ratio = results[(cut, BLOCK_MAJOR)]["us"] / results[(cut, ROW_MAJOR)]["us"]
        print(f"team {cut or 'full'}: block-major / row-major {ratio:.3f}", flush=True)
    return results


TEAM_WARPS = (4, 6, 8, 16)
TEAM_ENVS = (4096, 128)
# (label, one-thread kernel, team kernel, one-thread library, team library)
_TEAM_KERNELS = (
    ("K1", build.PHYSICS_STEP, build.PHYSICS_STEP_TEAM,
     lambda s, es, n: build.physics_step_library(s, n),
     lambda s, es, n, w: build.physics_step_team_library(s, n, w)),
    ("K2", build.ENV_STEP, build.ENV_STEP_TEAM,
     lambda s, es, n: build.env_step_library(s, es, n),
     lambda s, es, n, w: build.env_step_team_library(s, es, n, w)),
)


def build_team(s, es, n_substeps: int, warps: Sequence[int] = TEAM_WARPS):
    """The one-thread K1 and K2 and the team kernels at every W, built at
    once; returns their ``build.last_build`` names."""
    jobs, names = [], []
    for _, one, team, one_lib, team_lib in _TEAM_KERNELS:
        jobs.append(lambda f=one_lib: f(s, es, n_substeps))
        names.append(build.record_name(one))
        for w in warps:
            jobs.append(lambda f=team_lib, w=w: f(s, es, n_substeps, w))
            names.append(build.record_name(team, build.team_variant(team, w)))
    build.build_in_parallel(*jobs)
    return names


def team_sweep(s, es, n_substeps: int, blocks: Dict[str, Dict[int, list]],
               warps: Sequence[int] = TEAM_WARPS, iters: int = 20,
               runs: int = common.RUNS) -> Dict[tuple, dict]:
    """Time the one-thread and the team K1 and K2 (``blocks["K1"][B]``,
    ``blocks["K2"][B]``: each kernel's input blocks at B envs). Returns,
    per (kernel, B, W; W = 1 for the one-thread kernel), ``us`` per launch
    and the build's ptxas summary; fails unless every team launch equals
    the one-thread kernel's bit for bit."""
    from puppax_torch.env import soa_env
    from puppax_torch.physics import soa

    out_rows = {"K1": soa.physics_block_rows(s)[1], "K2": soa_env.env_block_rows(s, es)[1]}
    print(common.nvidia_smi(), flush=True)
    print(f"team kernels by warps per block: us per launch, best of {runs} windows of {iters} "
          "launches on the same inputs (CUDA events); W = 1 is the one-thread kernel:",
          flush=True)
    results = {}
    for label, one, team, one_lib, team_lib in _TEAM_KERNELS:
        variants = [(1, build.record_name(one), getattr(one_lib(s, es, n_substeps), one.launch))]
        for w in warps:
            lib = team_lib(s, es, n_substeps, w)
            variants.append((w, build.record_name(team, build.team_variant(team, w)),
                             getattr(lib, team.launch)))
        for B, bl in blocks[label].items():
            dev = bl[0].device
            ref = None
            for w, record, fn in variants:
                got = build.launch(record, fn, bl, out_rows[label], B, dev)
                torch.cuda.synchronize()
                if ref is None:
                    ref = got
                _, differing = common.compare_exact(got, ref)
                if differing:
                    raise AssertionError(f"team {label} at {w} warps, {B} envs: {differing} "
                                         "envs differ from the one-thread kernel")
                ms = common.best_ms(lambda: [build.launch(record, fn, bl, out_rows[label], B,
                                                          dev) for _ in range(iters)], runs)
                info = common.ptxas_info(record)
                smem = build.last_build[record].get("shared_bytes", 0)
                results[(label, B, w)] = dict(us=1e3 * ms / iters, shared_bytes=smem, **info)
                us = results[(label, B, w)]["us"]
                base = results[(label, B, 1)]["us"]
                print(f"{label} {B:5d} envs W={w:2d}: {us:10.1f} us ({base / us:5.2f}x the "
                      f"one-thread kernel); {info['registers']} registers, "
                      f"{info['spill_stores']} B spill stores, {smem} B shared", flush=True)
    return results


def team_blocks(device, envs: Sequence[int] = TEAM_ENVS):
    """The default env and the sweep's inputs: K1's nominal blocks, and
    K2's from a nominal reset of the env with zero actions and noise."""
    from puppax_torch.configs import EnvConfig
    from puppax_torch.env import soa_env
    from puppax_torch.env.pupper import PupperV3Env

    env = PupperV3Env.from_config(EnvConfig(), device=device)
    s, es = env._s, env._es
    key = random.key(0, device)
    out = {"K1": {}, "K2": {}}
    for B in envs:
        out["K1"][B] = common.nominal_blocks(s, env.model, B, device)
        key, key_reset = random.split(key).unbind(0)
        state = env.reset(random.split(key_reset, B))
        zeros = torch.zeros((es.nnoise_rows, B), dtype=torch.float32, device=device)
        out["K2"][B] = [soa_env.rows_block([state.qpos]), soa_env.rows_block([state.qvel]),
                        torch.zeros((s.nu, B), dtype=torch.float32, device=device),
                        soa_env.env_block(es, state.info, state.obs), zeros,
                        out["K1"][B][3]]
    return env, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--team", action="store_true",
                    help="sweep the team kernels' warps per block instead")
    args = ap.parse_args(argv)
    common.require_cuda("profile_layout")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    if args.team:
        env, blocks = team_blocks(device)
        common.print_builds(build_team(env._s, env._es, env._n_substeps))
        team_sweep(env._s, env._es, env._n_substeps, blocks)
    else:
        s, n_substeps, model = common.nominal_setup(device)
        common.print_builds(build_all(s, n_substeps))
        blocks = common.nominal_blocks(s, model, args.envs, device)
        run(s, n_substeps, blocks)
        run_team(s, n_substeps, blocks)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
