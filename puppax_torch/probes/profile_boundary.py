"""What does K1's (B, rows) <-> (rows, B) boundary cost on the physics-only lane?

    python -m puppax_torch.probes.profile_boundary [--envs 4096]

The H100 counterpart of ``dev/profile_boundary.py`` (``kernel_call`` :88 /
``pallas_call`` :89), which split the TPU's physics-only step into K1 on
tile-resident carries, the per-step transposes around it and the full
``_cv_pipeline_step`` splice. The kernel here is the production K1
(``soa.step_batched``: team K1, ``csrc/physics_step_team.cuh``). Four variants, each 50
steps with the state carried from K1's inputs (``window``), timed eagerly
and replayed from one CUDA graph (best of 3, CUDA events):

- ``rows_resident``: ``(rows, B)`` q and v straight into
  ``soa.step_batched`` (the TPU's ``tiles-resident``);
- ``transpose_bound``: ``(B, nq)`` / ``(B, nv)`` carries, ``.t().contiguous()``
  in, K1, ``.t().contiguous()`` out;
- ``transpose_only``: q, v and a ``(B, ncache)`` cache block transposed
  both ways, each times 1.0000001 (as the TPU variant, so the copies are
  the work); no kernel;
- ``splice``: ``PupperV3Env._cv_pipeline_step`` (``pipeline.make_batched_step``
  with the DR rows passed, as the physics-only lane passes them, and
  ``physics_state_from_caches``) on ``(B, rows)`` qpos and qvel. The
  carried qpos and qvel are K1's outputs seen as ``(B, rows)`` views, as
  the lane carries them, so the splice's ``.t().contiguous()`` copies
  nothing for them after the first step.

It prints us per step and M env-steps/s; ``transpose_bound - rows_resident``
is the boundary, and ``splice - rows_resident`` what the splice adds.
After the timing, the three K1 variants' final q and v must agree bit for
bit (the same kernel on the same values).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import torch

from puppax_torch.kernels import build
from puppax_torch.physics import soa
from puppax_torch.probes import common

SCALE = 1.0000001  # dev/profile_boundary.py:150-152


def rows_resident(s, n_substeps: int, ctrl, dr) -> Callable:
    """One step on ``(rows, B)`` q, v: K1 alone."""
    def step(q, v):
        return soa.step_batched(s, q, v, ctrl, dr, n_substeps)[:2]
    return step


def transpose_bound(s, n_substeps: int, ctrl, dr) -> Callable:
    """One step on ``(B, rows)`` q, v: transposed in, K1, transposed out."""
    def step(qb, vb):
        q2, v2, _ = soa.step_batched(s, qb.t().contiguous(), vb.t().contiguous(), ctrl, dr,
                                     n_substeps)
        return q2.t().contiguous(), v2.t().contiguous()
    return step


def transpose_only(*blocks):
    """One step of the transposes alone: each ``(B, rows)`` block to
    ``(rows, B)`` and back, times ``SCALE``."""
    return tuple(x.t().contiguous().t().contiguous() * SCALE for x in blocks)


def splice(env, ctrl_b, dr) -> Callable:
    """One step on ``(B, rows)`` qpos, qvel through the physics-only lane's
    ``_cv_pipeline_step`` under the motor targets ``ctrl_b`` ``(B, nu)``."""
    def step(qb, vb):
        ps = env._cv_pipeline_step(env.model, qb, vb, ctrl_b, dr)
        return ps.qpos, ps.qvel
    return step


def window(step: Callable, carry, iters: int):
    """``iters`` steps from ``carry`` (which it never writes); the last
    carry."""
    for _ in range(iters):
        carry = step(*carry)
    return carry


def run(env, blocks, iters: int = common.ITERS, runs: int = common.RUNS) -> Dict[str, object]:
    """Every variant on ``blocks`` (K1's q, v, ctrl, dr as ``(rows, B)``) with
    ``env``'s K1 (``env._cv_step.s``, ``env._n_substeps``). Returns, per
    variant, ``eager_us`` and ``graph_us`` per step and ``msteps_per_s``
    (graphed, M env-steps/s); under ``k1_launches`` the K1 launches the
    probe made (eager, and each graph replay's)."""
    s, n_substeps = env._cv_step.s, env._n_substeps
    q, v, ctrl, dr = blocks
    B = q.shape[1]
    qb, vb = q.t().contiguous(), v.t().contiguous()
    cases = {
        "rows_resident": (rows_resident(s, n_substeps, ctrl, dr), (q, v)),
        "transpose_bound": (transpose_bound(s, n_substeps, ctrl, dr), (qb, vb)),
        "transpose_only": (transpose_only, (qb, vb, torch.zeros((B, s.ncache), device=q.device))),
        "splice": (splice(env, ctrl.t().contiguous(), dr), (qb, vb)),
    }
    print(common.nvidia_smi(), flush=True)
    print(f"K1's boundary on the physics-only lane, {B} envs, {n_substeps} substeps, {iters} "
          f"steps per window with the state carried, best of {runs} windows (CUDA events), "
          f"eager and from one CUDA graph:", flush=True)
    results, before, graphed = {}, soa.step_batched.launches, 0
    for name, (step, carry) in cases.items():
        eager, graph = common.eager_and_graph_ms(lambda: window(step, carry, iters), runs)
        us = (eager * 1e3 / iters, graph * 1e3 / iters)
        results[name] = dict(eager_us=us[0], graph_us=us[1], msteps_per_s=B / us[1])
        graphed += iters if name != "transpose_only" else 0
        print(f"{name:16s} eager {us[0]:9.1f} us, graph {us[1]:9.1f} us per step, "
              f"{results[name]['msteps_per_s']:7.3f} M env-steps/s (graph)", flush=True)
    finals = {name: window(cases[name][0], cases[name][1], iters)
              for name in ("rows_resident", "transpose_bound", "splice")}
    # the wrapper counted each capture's calls as launches and no replay's
    results["k1_launches"] = soa.step_batched.launches - before + graphed * (runs - 1)
    want = finals["rows_resident"]
    for name in ("transpose_bound", "splice"):
        got = [x.t() for x in finals[name]]
        err, differing = common.compare_exact(got, want)
        if differing:
            raise AssertionError(f"{name}: {differing} of {B} envs differ from rows_resident "
                                 f"after {iters} steps (max abs err {err!r})")
    base = results["rows_resident"]["graph_us"]
    print(f"the boundary (transpose_bound - rows_resident): "
          f"{results['transpose_bound']['graph_us'] - base:.1f} us per step; the splice adds "
          f"{results['splice']['graph_us'] - base:.1f} us; after {iters} steps the three K1 "
          f"variants agree bit for bit; {results['k1_launches']} K1 launches", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    args = ap.parse_args(argv)
    common.require_cuda("profile_boundary")
    from puppax_torch.configs import EnvConfig
    from puppax_torch.env.pupper import PupperV3Env

    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    env = PupperV3Env.from_config(EnvConfig(), device=device)
    s = env._cv_step.s
    build.physics_step_team_library(s, env._n_substeps)
    common.print_builds([build.record_name(build.PHYSICS_STEP_TEAM)])
    run(env, common.nominal_blocks(s, env.model, args.envs, device))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
