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

The question on the H100: at 4096 envs K1's 32 blocks of 128 threads fill
32 of the 132 SMs, and one block alone took ~1.29 ms against ~1.7 ms for
all 32 on an NVIDIA H100 80GB HBM3 (``chip_smoke.py``, PERF.md). Smaller blocks spread the same envs over more SMs (128 blocks of 32
threads); the block-major layout makes each tile's rows contiguous.

Inputs as ``profile_kernel_phases``: the TPU probe's nominal states by
default; ``run`` takes any ``(rows, B)`` blocks.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from puppax_torch.kernels import build
from puppax_torch.probes import common
from puppax_torch.probes.common import BLOCK_MAJOR, ROW_MAJOR, from_block_major, to_block_major

PHASES = ("fk", None)
THREADS = (32, 64, 128)


def build_all(s, n_substeps: int):
    """The two libraries (fk cut and full body); returns their
    ``build.last_build`` names."""
    build.build_in_parallel(*[
        (lambda cut=cut: build.probe_physics_library(s, n_substeps, cut)) for cut in PHASES])
    return [build.record_name(build.PROBE_PHYSICS, cut or "full") for cut in PHASES]


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    args = ap.parse_args(argv)
    common.require_cuda("profile_layout")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    s, n_substeps, model = common.nominal_setup(device)
    common.print_builds(build_all(s, n_substeps))
    run(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
