"""Where K1's time goes: the physics step cut after each phase, on the card.

    python -m puppax_torch.probes.profile_kernel_phases [--envs 4096]

The H100 counterpart of ``dev/profile_kernel_phases.py`` (``kcall`` :68,
``pallas_call`` :69). It builds K1's body cut after each phase of
``soa.PHASES`` (fk, compos, comvel, crb, rne, smooth, efc; None is the whole
body) in the probe shell ``csrc/probe_physics.cuh``, all in one parallel
nvcc batch. A cut pads the outputs it has not reached with ``q[0]``, as the
TPU probe's emitter does; the shell's sink row, the sum of every value the
cut pass computed, keeps each phase's work live (without it nvcc drops
every phase no output reads). It times each build as 50 back-to-back launches with q
and v carried between two preallocated buffer sets (best of 3 windows, CUDA
events), eagerly and replayed from one captured CUDA graph: the graph, like
the TPU probe's tile-resident 50-step scan in one dispatch, leaves out the
host's launch work (which ``probe_launch_overhead`` measures, and which
can outlast a short cut's kernel), so its time is the device's. It prints
microseconds per step (the graph's, eager beside) and the delta from the
previous cut, so each delta is the cost of one phase. Each cut's first
launch is held bit for bit against its plain version
(``soa.physics_step_rows(..., phase_limit=cut, sink=True)``) on the same blocks: the
max abs err and the count of differing envs are printed, and a difference
raises.

Inputs: the TPU probe's own (``dev/profile_kernel_phases.py:39-42``): the
nominal model's qpos0 in every env, zero qvel, ctrl = qpos0[7:] and the
nominal parameter rows. ``run`` takes any ``(rows, B)`` blocks
(``chip_smoke.py`` passes its 4096 domain-randomized states).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from puppax_torch.kernels import build
from puppax_torch.physics import soa
from puppax_torch.probes import common


def build_all(s, n_substeps: int, phases: Sequence[Optional[str]] = soa.PHASES):
    """Build K1 once per cut, all nvcc processes at once; returns the
    ``build.last_build`` names."""
    build.build_in_parallel(*[
        (lambda cut=cut: build.probe_physics_library(s, n_substeps, cut)) for cut in phases])
    return [build.record_name(build.PROBE_PHYSICS, cut or "full") for cut in phases]


def run(s, n_substeps: int, blocks, phases: Sequence[Optional[str]] = soa.PHASES,
        iters: int = common.ITERS, runs: int = common.RUNS) -> Dict[Optional[str], dict]:
    """Time and check each cut on ``blocks`` (q, v, ctrl, dr as ``(rows,
    B)``). Returns, per cut: ``us`` per step, ``delta_us`` from the previous
    cut, ``max_abs_err`` and ``differing`` envs against the plain version,
    and ``plain_ms`` (one plain call)."""
    q, v, ctrl, dr = blocks
    B, dev = q.shape[1], q.device
    print(common.nvidia_smi(), flush=True)
    print(f"K1 cut after each phase (with the sink row), {B} envs, {n_substeps} substeps, "
          f"{iters} launches per window with q and v carried, best of {runs} windows (CUDA "
          f"events); us/step from one CUDA graph of the window (the device's time), eager "
          f"beside:", flush=True)
    results, prev = {}, 0.0
    for cut in phases:
        outs = common.empty_outputs(s, B, dev)
        common.physics_probe(s, n_substeps, blocks, outs, cut)  # held against the plain version
        plain = []
        plain_ms = common.window_ms(lambda: plain.append(soa.physics_step_rows(
            s, n_substeps, *blocks, phase_limit=cut, sink=True)))
        err, differing = common.compare_exact(outs, plain[0])

        def step(q_in, v_in, q_out, v_out, cut=cut, rest=outs[2:]):
            common.physics_probe(s, n_substeps, (q_in, v_in, ctrl, dr), (q_out, v_out, *rest),
                                 cut)

        times = common.carried_us(step, (q, v), iters, runs)
        us = times[1]
        print(f"{cut or 'full':8s} {us:10.1f} us/step  (+{us - prev:9.1f}); eager "
              f"{times[0]:10.1f} us/step; vs plain: max abs err {err!r}, {differing} of {B} "
              f"envs differ; plain {plain_ms:.1f} ms", flush=True)
        if differing:
            raise AssertionError(f"K1 cut after {cut or 'full'}: {differing} envs differ from "
                                 f"the plain version")
        results[cut] = dict(us=us, eager_us=times[0], delta_us=us - prev, max_abs_err=err,
                            differing=differing, plain_ms=plain_ms)
        prev = us
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    args = ap.parse_args(argv)
    common.require_cuda("profile_kernel_phases")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    s, n_substeps, model = common.nominal_setup(device)
    common.print_builds(build_all(s, n_substeps))
    run(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
