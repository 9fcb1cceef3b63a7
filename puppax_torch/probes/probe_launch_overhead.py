"""What does a launch cost on the card, with and without a CUDA graph?

    python -m puppax_torch.probes.probe_launch_overhead [--envs 4096]

The H100 counterpart of ``dev/probe_launch_overhead.py`` (``run`` :48,
``pallas_call`` :50), which timed 50-iteration scans of a trivial
``x + 1`` Pallas kernel (4 and 32 grid steps), of K1, and of an XLA
elementwise body, to tell launch overhead from kernel work. Here each case
is 50 back-to-back launches with the state carried, timed eagerly
and as one captured ``torch.cuda.CUDAGraph`` of the same launches replayed
(best of 3 windows, CUDA events; the graph is captured on its capture
stream, which the kernels' launch reads as the current stream):

- ``add_one`` (``csrc/probe_add_one.cuh``), ``x + 1`` over ``(8 nb, 8,
  128)`` float32 at nb = 4 and nb = 32, held bit for bit against ``x + 1``;
  ``x + 1`` as torch ops is timed beside it;
- K1's whole body (the probe shell's row-major build) at 4096 envs, q and v
  carried;
- the torch elementwise body ``c * 0.999 + 0.001`` on ``(4096, 64)`` (the
  TPU probe's XLA case, :87-95).

It prints microseconds per launch (per iteration for the torch body) for
each. A wrapper does not see a graph's replays, so each replay adds the
launches captured in the graph to ``common.launches``.

Then the host's side alone: the host time to issue one launch (50 calls
without waiting for the card, best of 3, host clock), layer by layer for
``x + 1``: the bare C entry point through ctypes with its arguments made
once, ``build.launch_into`` with the library looked up once, the
``add_one`` wrapper (checks, library lookup, count), and ``torch.add``.
``run`` also takes production launch paths (``chip_smoke.py`` passes team
K3's ``soa_env.wrapped_step`` and team K1's ``soa.step_batched`` on its 4096-env
states) and times their host side the same way. The bare launches bypass
the wrapper and its count.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import torch

from puppax_torch.kernels import build
from puppax_torch.probes import common

GRIDS = (4, 32)  # nb of dev/probe_launch_overhead.py:100-101
ELEMENTWISE_SHAPE = (4096, 64)  # dev/probe_launch_overhead.py:94


def add_one(x: torch.Tensor, out: torch.Tensor):
    """``out = x + 1``. CPU tensors run the plain version; CUDA tensors
    launch the kernel, or raise. Each launch counts in
    ``common.launches["add_one"]``."""
    if (x.dtype != torch.float32 or out.dtype != torch.float32 or x.shape != out.shape
            or not x.is_contiguous() or not out.is_contiguous() or x.device != out.device):
        raise ValueError("add_one: x and out must be contiguous float32 tensors of one shape "
                         "on one device")
    if x.device.type == "cpu":
        torch.add(x, 1.0, out=out)
        return
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    lib = build.add_one_library()
    build.launch_into("add_one", lib.add_one_launch, [x, out], x.numel())
    common.count_launch("add_one")


def run(s, n_substeps: int, blocks, iters: int = common.ITERS, runs: int = common.RUNS,
        production: Optional[Dict[str, Callable[[], object]]] = None) -> Dict[str, dict]:
    """Every case on ``blocks`` (K1's q, v, ctrl, dr as ``(rows, B)``).
    Returns, per case: ``eager_us`` and ``graph_us`` per launch, and for
    ``add_one`` at each nb also ``torch_us`` (``x + 1`` as one torch op:
    eager and graph) and ``max_abs_err`` against ``x + 1``; under
    ``"host"`` the host microseconds per call of each layer of ``x + 1``'s
    launch and of each ``production`` path (label -> a call making one
    launch)."""
    dev = blocks[0].device
    print(common.nvidia_smi(), flush=True)
    print(f"launch overhead, {iters} carried launches per window, best of {runs} windows, "
          f"eager and as one CUDA graph (CUDA events):", flush=True)
    results = {}
    for nb in GRIDS:
        x = torch.ones((8 * nb, 8, 128), dtype=torch.float32, device=dev)
        y = torch.empty_like(x)
        add_one(x, y)  # held against x + 1
        err, differing = common.compare_exact([y.reshape(1, -1)], [(x + 1).reshape(1, -1)])
        if differing:
            raise AssertionError(f"add_one nb={nb}: {differing} elements differ from x + 1")
        eager, graph = common.carried_us(add_one, (x,), iters, runs)
        torch_us = common.carried_us(lambda a, b: torch.add(a, 1.0, out=b), (x,), iters, runs)
        results[f"add_one_nb{nb}"] = dict(eager_us=eager, graph_us=graph, torch_us=torch_us,
                                          max_abs_err=err, numel=x.numel())
        print(f"add_one {tuple(x.shape)}: eager {eager:9.2f} us, graph {graph:9.2f} us per "
              f"launch; torch x + 1 eager {torch_us[0]:9.2f} us, graph {torch_us[1]:9.2f} us; "
              f"vs x + 1: max abs err {err!r}", flush=True)

    q, v, ctrl, dr = blocks
    rest = common.empty_outputs(s, q.shape[1], dev)[2:]  # caches and the sink row

    def k1_step(q_in, v_in, q_out, v_out):
        common.physics_probe(s, n_substeps, (q_in, v_in, ctrl, dr), (q_out, v_out, *rest))

    eager, graph = common.carried_us(k1_step, (q, v), iters, runs)
    results["k1"] = dict(eager_us=eager, graph_us=graph)
    print(f"K1 at {q.shape[1]} envs: eager {eager:9.2f} us, graph {graph:9.2f} us per launch",
          flush=True)

    def body(a, b):  # the torch body as the TPU probe's XLA scan: c * 0.999 + 0.001
        torch.add(torch.mul(a, 0.999), 0.001, out=b)

    c0 = torch.ones(ELEMENTWISE_SHAPE, dtype=torch.float32, device=dev)
    eager, graph = common.carried_us(body, (c0,), iters, runs)
    results["elementwise"] = dict(eager_us=eager, graph_us=graph)
    print(f"torch c * 0.999 + 0.001 on {ELEMENTWISE_SHAPE}: eager {eager:9.2f} us, graph "
          f"{graph:9.2f} us per iteration (two torch ops)", flush=True)

    x = torch.ones((8 * GRIDS[0], 8, 128), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    fn = build.add_one_library().add_one_launch
    args = (x.data_ptr(), y.data_ptr(), x.numel(), torch.cuda.current_stream(dev).cuda_stream)
    layers = {
        "add_one: C entry point through ctypes": lambda: fn(*args),
        "add_one: build.launch_into": lambda: build.launch_into("add_one", fn, [x, y],
                                                                x.numel()),
        "add_one: the wrapper": lambda: add_one(x, y),
        "torch.add(x, 1)": lambda: torch.add(x, 1.0, out=y),
        **(production or {}),
    }
    print(f"host time to issue one call ({iters} calls per window without waiting for the "
          f"card, best of {runs}, host clock):", flush=True)
    results["host"] = {}
    for label, call in layers.items():
        results["host"][label] = us = common.host_us(call, iters, runs)
        print(f"  {label}: {us:9.2f} us per call", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    args = ap.parse_args(argv)
    common.require_cuda("probe_launch_overhead")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    s, n_substeps, model = common.nominal_setup(device)
    build.build_in_parallel(build.add_one_library,
                            lambda: build.probe_physics_library(s, n_substeps, None))
    common.print_builds([build.record_name(build.ADD_ONE),
                         build.record_name(build.PROBE_PHYSICS, "full")])
    run(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
