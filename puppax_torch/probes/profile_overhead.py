"""What does a launch cost beside its work? Copy kernels over K1's operands.

    python -m puppax_torch.probes.profile_overhead [--envs 4096]

The H100 counterpart of ``dev/profile_overhead.py`` (``call_copy`` :97 /
``pallas_call`` :98, ``call_copy_min`` :119 / :120, ``call_fk`` :138 /
:139, ``call_copy_1`` :162 / :163), which told a Pallas call's fixed cost
(launch and operand DMA) from its compute with copy kernels over K1's
operand set and ablations of it. Each case here is 50 launches with q and
v carried (``common.carried_us``: best of 3 windows, eagerly and replayed
from one CUDA graph, whose time is the device's):

- ``copy_full`` (``csrc/probe_copy.cuh``, mode full) over K1's operands:
  q, v, ctrl and dr in; q and v + 1e-7, every cache row = q[0] and the
  sink row (the sum of ctrl and dr, which gives the kernel the TPU DMA's
  operand traffic) out: ``call_copy``;
- ``copy_min``: q and v only: ``call_copy_min``;
- K1 cut after FK with its sink row (``call_fk``), in two designs timed in
  turns (one-thread, team, team, one-thread; the better of each pair),
  each held bit for bit against the plain version
  (``soa.physics_step_rows(..., phase_limit="fk", sink=True)``): one
  thread per env (``csrc/probe_physics.cuh``, P1's fk build; launch name
  ``fk_cut``) and a team build of the fk cut (``csrc/probe_physics_team.cuh``,
  ``P7_WARPS`` warps, stage budget ``P7_CAP``) whose substep loop is
  partitioned across the warps like straight-line code (``P7_LOOP_WEIGHT``
  lies below the loop's weight; production's schedule runs it whole in
  every warp), its carries in shared slots (launch name ``fk_cut_team``);
- ``copy_full`` at one 128-thread block (the first 128 envs):
  ``call_copy_1``'s grid = 1, where one TPU grid step was 1024 envs.

Each copy is first held bit for bit against its plain version
(``common.check_copy``), then timed beside the same file's one-thread copy
(``common.copy_probe_one_thread``, the A/B baseline of the
element-parallel design). It prints us per launch and the cost of one more
block, ``(full at B - full at 128) / (B / 128 - 1)`` from the graphed
times.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from puppax_torch.kernels import build
from puppax_torch.physics import soa
from puppax_torch.probes import common

# P7's team build: the fk cut with its substep loop partitioned (a loop
# weight below the loop's), W and the stage budget chosen on the card from
# profile_team.py --kernel P7 (PERF.md)
P7_WARPS = 4
P7_CAP = 128
P7_LOOP_WEIGHT = 0
FK, FK_TEAM = "fk_cut", "fk_cut_team"  # the launch names of P7's two designs


def fk_team_library(s, n_substeps: int):
    """P7's team build (``build.probe_physics_team_library`` of the fk cut at
    ``P7_WARPS``, ``P7_LOOP_WEIGHT``, ``P7_CAP``)."""
    return build.probe_physics_team_library(s, n_substeps, "fk", warps=P7_WARPS,
                                            loop_weight=P7_LOOP_WEIGHT, cap=P7_CAP)


def fk_team_record() -> str:
    """The build record of P7's team build."""
    return build.record_name(build.PROBE_PHYSICS_TEAM, build.team_probe_variant(
        "fk", P7_WARPS, P7_LOOP_WEIGHT, P7_CAP))


def fk_step(s, n_substeps: int, blocks, outs, team: bool):
    """One step of P7's team build (``team``) or of the one-thread fk cut
    into the preallocated ``outs`` (q, v, caches, sink); launch names
    ``FK_TEAM`` and ``FK``."""
    if team:
        common.physics_probe_team(s, n_substeps, blocks, outs, "fk", warps=P7_WARPS,
                                  loop_weight=P7_LOOP_WEIGHT, cap=P7_CAP, name=FK_TEAM)
    else:
        common.physics_probe(s, n_substeps, blocks, outs, "fk", name=FK)


def check_fk(s, n_substeps: int, blocks) -> dict:
    """One launch of each of P7's designs held bit for bit against the plain
    fk cut (``soa.physics_step_rows(..., phase_limit="fk", sink=True)``) on
    ``blocks``; raises if an env differs. Returns the team build's
    ``max_abs_err`` and ``differing``, ``one_thread`` (the same of the
    one-thread cut) and the plain version's ``plain_ms``."""
    want = []
    plain_ms = common.window_ms(lambda: want.append(soa.physics_step_rows(
        s, n_substeps, *blocks, phase_limit="fk", sink=True)))
    out = {}
    for team in (False, True):
        got = common.empty_outputs(s, blocks[0].shape[1], blocks[0].device)
        fk_step(s, n_substeps, blocks, got, team)
        err, differing = common.compare_exact(got, want[0])
        if differing:
            raise AssertionError(f"{FK_TEAM if team else FK}: {differing} of "
                                 f"{blocks[0].shape[1]} envs differ from the plain fk cut")
        out[team] = dict(max_abs_err=err, differing=differing)
    return dict(out[True], one_thread=out[False], plain_ms=plain_ms)


def run_fk(s, n_substeps: int, blocks, iters: int = common.ITERS, runs: int = common.RUNS,
           check_envs=(common.TILE,)) -> Dict[str, dict]:
    """P7 on ``blocks``: both designs held bit for bit against the plain fk
    cut at B and at each of ``check_envs`` (the first envs), then timed in
    turns (one-thread, team, team, one-thread; the better of each pair).
    Returns ``fk`` (the one-thread cut) and ``fk_team`` (P7's team build),
    each with ``envs``, ``eager_us``, ``graph_us`` and ``checks`` (envs ->
    ``check_fk``'s dict)."""
    q, v, ctrl, dr = blocks
    B = q.shape[1]
    checks = {n: check_fk(s, n_substeps, [x[:, :n].contiguous() for x in blocks])
              for n in dict.fromkeys((B, *check_envs))}
    for n, c in checks.items():
        print(f"{FK_TEAM} vs plain at {n} envs: max abs err {c['max_abs_err']!r}, "
              f"{c['differing']} envs differ; {FK}: {c['one_thread']['differing']} envs differ; "
              f"plain {c['plain_ms']:.3f} ms", flush=True)
    rest = common.empty_outputs(s, B, q.device)[2:]

    def carried(team):
        def step(q_in, v_in, q_out, v_out):
            fk_step(s, n_substeps, (q_in, v_in, ctrl, dr), (q_out, v_out, *rest), team)

        return step

    turns = [common.carried_us(carried(team), (q, v), iters, runs)
             for team in (False, True, True, False)]
    best = {"fk": (turns[0], turns[3]), "fk_team": (turns[1], turns[2])}
    out = {name: dict(envs=B, checks=checks, eager_us=min(a[0], b[0]), graph_us=min(a[1], b[1]))
           for name, (a, b) in best.items()}
    one, team = out["fk"], out["fk_team"]
    stats = build.last_build[fk_team_record()]
    print(f"{'fk':20s} at {B:5d} envs: eager {one['eager_us']:9.2f} us, graph "
          f"{one['graph_us']:9.2f} us per launch (K1 cut after fk, its sink row, one thread per "
          "env)", flush=True)
    print(f"{'fk_team':20s} at {B:5d} envs: eager {team['eager_us']:9.2f} us, graph "
          f"{team['graph_us']:9.2f} us per launch ({one['graph_us'] / team['graph_us']:.2f}x the "
          f"one-thread cut, in turns; {stats['warps']} warps, substep loop partitioned: heaviest "
          f"stream {max(stats['stream_ops'])} of {stats['ops_per_env']} ops, "
          f"{stats['replicated_ops']} replicated, {stats['barriers']} barriers, "
          f"{stats['shared_bytes']} B shared)", flush=True)
    return out


def run(s, n_substeps: int, blocks, iters: int = common.ITERS, runs: int = common.RUNS,
        fk_check_envs=(common.TILE,)) -> Dict[str, object]:
    """Every case on ``blocks`` (K1's q, v, ctrl, dr as ``(rows, B)``).
    Returns, per copy (``copy_full``, ``copy_min``,
    ``copy_full_one_block``): ``eager_us`` and ``graph_us`` per launch,
    ``envs``, ``max_abs_err``, ``differing``, ``plain_ms`` and
    ``one_thread_us`` (the one-thread copy's eager and graph us); under
    ``per_block_us`` the graphed cost of one more block; and ``run_fk``'s
    ``fk`` and ``fk_team`` (checked at B and ``fk_check_envs``)."""
    q = blocks[0]
    B = q.shape[1]
    one = [x[:, : common.TILE].contiguous() for x in blocks]
    print(common.nvidia_smi(), flush=True)
    print(f"launch overhead beside the operands, {iters} launches per window with q and v "
          f"carried, best of {runs} windows (CUDA events), eager and from one CUDA graph:",
          flush=True)

    def copy_step(mode, ins, copy=common.copy_probe):
        rest = common.copy_outputs(mode, ins, s.ncache)[2:]  # caches and the sink row

        def step(q_in, v_in, q_out, v_out):
            copy(mode, (q_in, v_in, *ins[2:]), (q_out, v_out, *rest))

        return step

    cases = {
        "copy_full": ("full", blocks),
        "copy_min": ("min", blocks[:2]),
        "copy_full_one_block": ("full", one),
    }
    results = {}
    for name, (mode, ins) in cases.items():
        res = dict(envs=ins[0].shape[1])
        err, differing, plain_ms = common.check_copy(mode, ins, s.ncache)
        res.update(max_abs_err=err, differing=differing, plain_ms=plain_ms)
        res["eager_us"], res["graph_us"] = common.carried_us(copy_step(mode, ins), ins[:2],
                                                             iters, runs)
        res["one_thread_us"] = common.carried_us(
            copy_step(mode, ins, common.copy_probe_one_thread), ins[:2], iters, runs)
        results[name] = res
        print(f"{name:20s} at {res['envs']:5d} envs: eager {res['eager_us']:9.2f} us, graph "
              f"{res['graph_us']:9.2f} us per launch; one-thread copy: eager "
              f"{res['one_thread_us'][0]:.2f} us, graph {res['one_thread_us'][1]:.2f} us "
              f"({res['one_thread_us'][1] / res['graph_us']:.2f}x the graph); vs plain: max abs "
              f"err {res['max_abs_err']!r}, {res['differing']} of {res['envs']} envs differ; "
              f"plain {res['plain_ms']:.3f} ms", flush=True)
    blocks_more = B // common.TILE - 1
    if blocks_more > 0:
        results["per_block_us"] = (results["copy_full"]["graph_us"]
                                   - results["copy_full_one_block"]["graph_us"]) / blocks_more
        print(f"one more 128-env block of copy_full: {results['per_block_us']:.4f} us "
              f"((graph at {B} - graph at {common.TILE}) / {blocks_more})", flush=True)
    results.update(run_fk(s, n_substeps, blocks, iters, runs, fk_check_envs))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    args = ap.parse_args(argv)
    common.require_cuda("profile_overhead")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    s, n_substeps, model = common.nominal_setup(device)
    build.build_in_parallel(build.probe_copy_library,
                            lambda: build.probe_physics_library(s, n_substeps, "fk"),
                            lambda: fk_team_library(s, n_substeps))
    common.print_builds([build.record_name(build.PROBE_COPY),
                         build.record_name(build.PROBE_PHYSICS, "fk"), fk_team_record()])
    run(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
