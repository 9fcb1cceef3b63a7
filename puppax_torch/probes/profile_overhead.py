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
- K1 cut after FK in its probe shell (``common.physics_probe(..., "fk")``,
  with its sink row): ``call_fk``;
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
from puppax_torch.probes import common


def run(s, n_substeps: int, blocks, iters: int = common.ITERS,
        runs: int = common.RUNS) -> Dict[str, object]:
    """Every case on ``blocks`` (K1's q, v, ctrl, dr as ``(rows, B)``).
    Returns, per case (``copy_full``, ``copy_min``, ``fk``,
    ``copy_full_one_block``): ``eager_us`` and ``graph_us`` per launch,
    ``envs``, and for the copies ``max_abs_err``, ``differing``,
    ``plain_ms`` and ``one_thread_us`` (the one-thread copy's eager and
    graph us); under ``per_block_us`` the graphed cost of one more block."""
    q, v, ctrl, dr = blocks
    B, dev = q.shape[1], q.device
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

    fk_rest = common.empty_outputs(s, B, dev)[2:]

    def fk_step(q_in, v_in, q_out, v_out):
        common.physics_probe(s, n_substeps, (q_in, v_in, ctrl, dr), (q_out, v_out, *fk_rest), "fk")

    cases = {
        "copy_full": ("full", blocks),
        "copy_min": ("min", blocks[:2]),
        "fk": (None, blocks),
        "copy_full_one_block": ("full", one),
    }
    results = {}
    for name, (mode, ins) in cases.items():
        res = dict(envs=ins[0].shape[1])
        if mode is not None:
            err, differing, plain_ms = common.check_copy(mode, ins, s.ncache)
            res.update(max_abs_err=err, differing=differing, plain_ms=plain_ms)
        step = fk_step if mode is None else copy_step(mode, ins)
        res["eager_us"], res["graph_us"] = common.carried_us(step, ins[:2], iters, runs)
        if mode is not None:
            res["one_thread_us"] = common.carried_us(
                copy_step(mode, ins, common.copy_probe_one_thread), ins[:2], iters, runs)
        results[name] = res
        check = (f"; one-thread copy: eager {res['one_thread_us'][0]:.2f} us, graph "
                 f"{res['one_thread_us'][1]:.2f} us ({res['one_thread_us'][1] / res['graph_us']:.2f}x"
                 f" the graph); vs plain: max abs err {res['max_abs_err']!r}, {res['differing']} "
                 f"of {res['envs']} envs differ; plain {res['plain_ms']:.3f} ms"
                 if mode is not None else " (K1 cut after fk, its sink row)")
        print(f"{name:20s} at {res['envs']:5d} envs: eager {res['eager_us']:9.2f} us, graph "
              f"{res['graph_us']:9.2f} us per launch{check}", flush=True)
    blocks_more = B // common.TILE - 1
    if blocks_more > 0:
        results["per_block_us"] = (results["copy_full"]["graph_us"]
                                   - results["copy_full_one_block"]["graph_us"]) / blocks_more
        print(f"one more 128-env block of copy_full: {results['per_block_us']:.4f} us "
              f"((graph at {B} - graph at {common.TILE}) / {blocks_more})", flush=True)
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
                            lambda: build.probe_physics_library(s, n_substeps, "fk"))
    common.print_builds([build.record_name(build.PROBE_COPY),
                         build.record_name(build.PROBE_PHYSICS, "fk")])
    run(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
