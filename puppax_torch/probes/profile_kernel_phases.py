"""Where K1's time goes: the physics step cut after each phase, on the card.

    python -m puppax_torch.probes.profile_kernel_phases [--envs 4096]

The H100 counterpart of ``dev/profile_kernel_phases.py`` (``kcall`` :68,
``pallas_call`` :69). It builds K1's program cut after each phase of
``soa.PHASES`` (fk, compos, comvel, crb, rne, smooth, efc; None is the whole
program) in two designs, all in one parallel nvcc batch:

- team (the production K1's design): the cut program split across the 4
  warps of a block by ``kernels/team.py`` with production's knobs, in the
  shell ``csrc/probe_physics_team.cuh`` (``common.physics_probe_team``);
- one-thread (the A/B): the cut body run by one thread per env, in the
  shell ``csrc/probe_physics.cuh`` (``common.physics_probe``).

A cut pads the outputs it has not reached with ``q[0]``, as the TPU probe's
emitter does; the shells' sink row, the sum of every value the cut pass
computed, keeps each phase's work live (without it nvcc drops every phase
no output reads). Each build is timed as 50 back-to-back launches with q
and v carried between two preallocated buffer sets (best of 3 windows, CUDA
events), eagerly and replayed from one captured CUDA graph: the graph, like
the TPU probe's tile-resident 50-step scan in one dispatch, leaves out the
host's launch work (which ``probe_launch_overhead`` measures, and which
can outlast a short cut's kernel), so its time is the device's. The two
designs are timed in turns on the same blocks (one-thread, team, team,
one-thread; the better of each pair). It prints microseconds per step (the
graph's, eager beside) and the delta from the previous cut of the same
design; for a team cut also the schedule's heaviest warp stream (and its
delta), replicated operations, barriers and shared bytes, and ptxas's
registers, stack and spills. The cuts are scheduled one by one, so a team
delta is a phase's cost only where the neighbouring schedules agree: the
scheduler replicates most of the fk cut in every warp, which makes it
heavier than the compos cut. Each cut's plain version
(``soa.physics_step_rows(..., phase_limit=cut, sink=True)``) is computed
once and both designs' first launches are held bit for bit against it: the
max abs err and the count of differing envs are printed, and a difference
raises. The team full cut (sink row 0) is held bit for bit against the
production team K1 (``soa.step_batched``) and timed beside it.

Inputs: the TPU probe's own (``dev/profile_kernel_phases.py:39-42``): the
nominal model's qpos0 in every env, zero qvel, ctrl = qpos0[7:] and the
nominal parameter rows. ``run`` takes any ``(rows, B)`` blocks
(``chip_smoke.py`` passes its 4096 domain-randomized states).
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from puppax_torch.kernels import build
from puppax_torch.physics import soa
from puppax_torch.probes import common, profile_boundary

# the two designs, timed in turns: label -> (probe wrapper, shell, library)
DESIGNS = {
    "one-thread": (common.physics_probe, build.PROBE_PHYSICS, build.probe_physics_library),
    "team": (common.physics_probe_team, build.PROBE_PHYSICS_TEAM,
             build.probe_physics_team_library),
}


def record(cut: Optional[str], design: str = "one-thread") -> str:
    """The ``build.last_build`` name of one cut's build."""
    return build.record_name(DESIGNS[design][1], cut or "full")


def build_all(s, n_substeps: int, phases: Sequence[Optional[str]] = soa.PHASES):
    """Build every cut in both designs, all nvcc processes at once; returns
    the ``build.last_build`` names."""
    build.build_in_parallel(*[(lambda f=lib, cut=cut: f(s, n_substeps, cut))
                              for _, _, lib in DESIGNS.values() for cut in phases])
    return [record(cut, d) for d in DESIGNS for cut in phases]


def _team_line(cut: Optional[str], prev_stream: int) -> Tuple[dict, str]:
    """A team cut's schedule and ptxas numbers from its build record, and
    their text (the heaviest stream's delta from ``prev_stream``)."""
    rec = build.last_build[record(cut, "team")]
    if rec["ops_per_env"] != build.last_build[record(cut)]["ops_per_env"]:
        raise AssertionError(f"team and one-thread cut {cut or 'full'}: operation counts differ")
    st = dict(heaviest_stream=max(rec["stream_ops"]), replicated_ops=rec["replicated_ops"],
              barriers=rec["barriers"], shared_bytes=rec["shared_bytes"],
              **common.ptxas_info(record(cut, "team")))
    return st, (f"; heaviest stream {st['heaviest_stream']} ops "
                f"({st['heaviest_stream'] - prev_stream:+d}), {st['replicated_ops']} replicated, "
                f"{st['barriers']} barriers, {st['shared_bytes']} B shared; ptxas "
                f"{st['registers']} registers, {st['stack']} B stack, {st['spill_stores']} B "
                f"spill stores, {st['spill_loads']} B spill loads")


def run(s, n_substeps: int, blocks, phases: Sequence[Optional[str]] = soa.PHASES,
        iters: int = common.ITERS, runs: int = common.RUNS) -> Dict[Optional[str], dict]:
    """Time and check each cut in both designs on ``blocks`` (q, v, ctrl,
    dr as ``(rows, B)``). Returns, per cut: under each design
    (``"one-thread"``, ``"team"``) ``us`` per step, ``eager_us``,
    ``delta_us`` from the previous cut, ``max_abs_err`` and ``differing``
    envs against the plain version (the team cuts also ``stats``: the
    schedule's and ptxas's numbers); ``plain_ms`` (one plain call); and for
    the whole program ``production``, team K1's (``soa.step_batched``)
    ``us`` and ``eager_us``."""
    q, v, ctrl, dr = blocks
    B, dev = q.shape[1], q.device
    print(common.nvidia_smi(), flush=True)
    print(f"K1 cut after each phase (with the sink row), {B} envs, {n_substeps} substeps, "
          f"{iters} launches per window with q and v carried, best of {runs} windows (CUDA "
          f"events); us/step from one CUDA graph of the window (the device's time), eager "
          f"beside; team and one-thread in turns on the same blocks:", flush=True)
    results, prev = {}, {d: (0.0, 0) for d in DESIGNS}  # the previous cut's us, stream
    for cut in phases:
        plain = []
        plain_ms = common.window_ms(lambda: plain.append(soa.physics_step_rows(
            s, n_substeps, *blocks, phase_limit=cut, sink=True)))
        res, steps, outs = {"plain_ms": plain_ms}, {}, {}
        for d, (probe, _, _) in DESIGNS.items():
            outs[d] = common.empty_outputs(s, B, dev)
            probe(s, n_substeps, blocks, outs[d], cut)  # eager: a team build sizes its shared mem
            err, differing = common.compare_exact(outs[d], plain[0])
            if differing:
                raise AssertionError(f"{d} K1 cut after {cut or 'full'}: {differing} envs "
                                     f"differ from the plain version")
            res[d] = dict(max_abs_err=err, differing=differing, us=math.inf)

            def step(q_in, v_in, q_out, v_out, probe=probe,
                     rest=[torch.empty_like(x) for x in outs[d][2:]]):
                probe(s, n_substeps, (q_in, v_in, ctrl, dr), (q_out, v_out, *rest), cut)

            steps[d] = step
        for d in list(DESIGNS) + list(DESIGNS)[::-1]:  # in turns
            eager, us = common.carried_us(steps[d], (q, v), iters, runs)
            if us < res[d]["us"]:
                res[d].update(us=us, eager_us=eager)
        for d in DESIGNS:
            r = res[d]
            r["delta_us"] = r["us"] - prev[d][0]
            line = (f"{cut or 'full':8s} {d:10s} {r['us']:10.1f} us/step ({r['delta_us']:+9.1f}); "
                    f"eager {r['eager_us']:10.1f} us/step")
            stream = 0
            if d == "team":
                r["stats"], text = _team_line(cut, prev[d][1])
                line += text
                stream = r["stats"]["heaviest_stream"]
            prev[d] = (r["us"], stream)
            print(line + f"; vs plain: max abs err {r['max_abs_err']!r}, {r['differing']} of "
                  f"{B} envs differ; plain {plain_ms:.1f} ms", flush=True)
        if cut is None:
            res["production"] = production(s, n_substeps, blocks, outs["team"], iters, runs)
        results[cut] = res
    if "efc" in results and None in results:
        efc, full = results["efc"]["team"]["us"], results[None]["team"]["us"]
        print(f"team: efc -> full {full - efc:.1f} us per step, {(full - efc) / full:.1%} of "
              f"the team full cut", flush=True)
    return results


def production(s, n_substeps: int, blocks, team_outs, iters: int = common.ITERS,
               runs: int = common.RUNS) -> dict:
    """The production team K1 (``soa.step_batched``) on ``blocks``: held
    bit for bit against the team full cut's q, v and caches (``team_outs``)
    and timed as ``iters`` carried steps, eagerly and from one CUDA graph
    (``profile_boundary.window``). Returns ``us``, ``eager_us``."""
    q, v, ctrl, dr = blocks
    err, differing = common.compare_exact(soa.step_batched(s, *blocks, n_substeps),
                                          team_outs[:3])
    if differing:
        raise AssertionError(f"the team full cut and team K1 (soa.step_batched): {differing} "
                             f"envs differ (max abs err {err!r})")
    step = profile_boundary.rows_resident(s, n_substeps, ctrl, dr)
    eager, graph = common.eager_and_graph_ms(
        lambda: profile_boundary.window(step, (q, v), iters), runs)
    us = dict(us=graph * 1e3 / iters, eager_us=eager * 1e3 / iters)
    print(f"production team K1 (soa.step_batched) {us['us']:10.1f} us/step; eager "
          f"{us['eager_us']:10.1f} us/step; the team full cut equals it bit for bit (0 envs "
          f"differ)", flush=True)
    return us


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
