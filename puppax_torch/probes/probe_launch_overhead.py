"""What does a launch cost on the card, with and without a CUDA graph, and
does programmatic dependent launch shorten a chain of dependent launches?

    python -m puppax_torch.probes.probe_launch_overhead [--envs 4096]

The H100 counterpart of ``dev/probe_launch_overhead.py`` (``run`` :48,
``pallas_call`` :50), which timed 50-iteration scans of a trivial
``x + 1`` Pallas kernel (4 and 32 grid steps), of K1, and of an XLA
elementwise body, to tell launch overhead from kernel work. Here each case
is 50 back-to-back launches with the state carried, timed eagerly
and as one captured ``torch.cuda.CUDAGraph`` of the same launches replayed
(best of 3 windows, CUDA events; the graph is captured on its capture
stream, which the kernels' launch reads as the current stream):

- ``x + 1`` over ``(8 nb, 8, 128)`` float32 at nb = 4 and nb = 32, in two
  designs of ``csrc/probe_add_one.cuh``: ``add_one``, the redesign (float4
  on a grid of ``PER_SM`` blocks of ``THREADS`` threads on each SM,
  launched with programmatic dependent launch, PDL), with the launch
  attribute and without it, and ``add_one_one_element`` (one element per
  thread, the A/B baseline), beside ``torch.add(x, 1, out=y)``, timed in
  turns (one-element, PDL, no PDL, torch, torch, no PDL, PDL,
  one-element; the better of each pair). ``check`` holds each design bit
  for bit against ``x + 1`` at both nb and at a ragged and a misaligned
  ``n``; ``graph_chain`` captures a carried PDL chain, counts the
  programmatic edges of the graph (it raises if there are none: a graph
  without them would time the redesign without PDL) and holds the
  replay's result bit for bit;
- the graphed chain at 1, 2, 10 and 50 launches, with and without PDL:
  how much of the per-launch time the overlap removes;
- K1's whole body (the probe shell's row-major build) at 4096 envs, q and v
  carried;
- the torch elementwise body ``c * 0.999 + 0.001`` on ``(4096, 64)`` (the
  TPU probe's XLA case, :87-95).

It prints microseconds per launch (per iteration for the torch body) for
each. A wrapper does not see a graph's replays, so each replay adds the
launches captured in the graph to ``common.launches``.

Then the host's side alone: the host time to issue one launch (50 calls
without waiting for the card, best of 3, host clock), layer by layer for
``x + 1``: the redesign's bare C entry point through ctypes with its
arguments made once, ``build.launch_into`` with the library looked up
once, the ``add_one`` wrapper (checks, library lookup, count), the
one-element kernel's wrapper, and ``torch.add``. ``run`` also takes
production launch paths (``chip_smoke.py`` passes team K3's
``soa_env.wrapped_step`` and team K1's ``soa.step_batched`` on its
4096-env states) and times their host side the same way. The bare launches
bypass the wrapper and its count.

The command line then sweeps the redesign's threads per block
(``SWEEP_THREADS``) and blocks per SM (``SWEEP_PER_SM``), graphed, with and
without PDL, at both nb (``sweep``); ``THREADS`` and ``PER_SM`` are the
sweep's best.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Callable, Dict, Optional

import torch

from puppax_torch.kernels import build
from puppax_torch.probes import common

GRIDS = (4, 32)  # nb of dev/probe_launch_overhead.py:100-101
ELEMENTWISE_SHAPE = (4096, 64)  # dev/probe_launch_overhead.py:94
# the redesign's block and grid (the best of the sweep on the card; PERF.md)
THREADS = 256
PER_SM = 2
SWEEP_THREADS = (128, 256, 512, 1024)
SWEEP_PER_SM = (1, 2, 4)
CHAIN_LENGTHS = (1, 2, 10, 50)
ONE_ELEMENT = "add_one[one-element]"  # the launch name of the one-element kernel
# check's cases beyond (8 nb, 8, 128): a count that is not a multiple of 4
# or of a block, and the same count 4 bytes past a 16-byte boundary
RAGGED = 8 * GRIDS[-1] * 8 * 128 + 3


def _check(x: torch.Tensor, out: torch.Tensor):
    if (x.dtype != torch.float32 or out.dtype != torch.float32 or x.shape != out.shape
            or not x.is_contiguous() or not out.is_contiguous() or x.device != out.device):
        raise ValueError("add_one: x and out must be contiguous float32 tensors of one shape "
                         "on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"add_one: unsupported device {x.device}")


def add_one(x: torch.Tensor, out: torch.Tensor, pdl: bool = True, threads: int = THREADS,
            per_sm: int = PER_SM):
    """``out = x + 1`` through the redesign: float4 where both tensors are
    16-byte aligned, on a grid of ``per_sm`` blocks of ``threads`` threads
    on each SM, launched with programmatic dependent launch if ``pdl``.
    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise. Each launch counts in ``common.launches["add_one"]``."""
    _check(x, out)
    if x.device.type == "cpu":
        torch.add(x, 1.0, out=out)
        return
    lib = build.add_one_pdl_library()
    build.launch_into("add_one", lib.add_one_pdl_launch, [x, out], x.numel(), threads, per_sm,
                      int(pdl))
    common.count_launch("add_one")


def add_one_one_element(x: torch.Tensor, out: torch.Tensor):
    """``add_one`` through the one-element-per-thread kernel (1024-thread
    blocks, a plain launch), the A/B baseline. Each launch counts in
    ``common.launches[ONE_ELEMENT]``."""
    _check(x, out)
    if x.device.type == "cpu":
        torch.add(x, 1.0, out=out)
        return
    build.launch_into(ONE_ELEMENT, build.add_one_library().add_one_launch, [x, out], x.numel())
    common.count_launch(ONE_ELEMENT)


def _no_pdl(x, out):
    add_one(x, out, pdl=False)


def _torch_add(x, out):
    torch.add(x, 1.0, out=out)


DESIGNS = {"one-element": add_one_one_element, "PDL": add_one, "no PDL": _no_pdl,
           "torch.add": _torch_add}


def check(device, seed: int = 0) -> Dict[str, tuple]:
    """Each kernel design (PDL, no PDL, one-element) against ``x + 1`` on
    the same random inputs, bit for bit: at nb = 4 and 32, at ``RAGGED``
    elements and at ``RAGGED`` elements 4 bytes past a 16-byte boundary
    (the scalar path). Returns label -> (max abs err, differing elements)
    per design; raises if one element differs."""
    g = torch.Generator(device=device).manual_seed(seed)
    cases = [(f"nb={nb}", 8 * nb * 8 * 128, 0) for nb in GRIDS]
    cases += [(f"n={RAGGED}", RAGGED, 0), (f"n={RAGGED} misaligned", RAGGED, 1)]
    out = {}
    for label, n, offset in cases:
        buf = torch.randn(n + offset, generator=g, device=device)
        x = buf[offset:]
        want = x + 1
        res = {}
        for name in ("PDL", "no PDL", "one-element"):
            ybuf = torch.full((n + offset,), float("nan"), device=device)
            y = ybuf[offset:]
            DESIGNS[name](x, y)
            res[name] = common.compare_exact([y.reshape(1, -1)], [want.reshape(1, -1)])
            if res[name][1]:
                raise AssertionError(f"add_one ({name}) {label}: {res[name][1]} elements differ "
                                     f"from x + 1")
        out[label] = res
        print(f"add_one vs x + 1 at {label} ({n} elements): " + ", ".join(
            f"{name} max abs err {e!r}, {d} differ" for name, (e, d) in res.items()), flush=True)
    return out


def graph_chain(x: torch.Tensor, iters: int = common.ITERS) -> dict:
    """``iters`` carried PDL launches of ``add_one`` from ``x``, captured as
    one CUDA graph: the edges of the captured graph (``edges``) and how many
    are programmatic (``programmatic``), then one replay held bit for bit
    against ``iters`` torch adds of 1 (``max_abs_err``, ``differing``).
    Raises if the graph holds no programmatic edge."""
    lib = build.add_one_pdl_library()
    c = common.Carry(add_one, (x,), iters)
    counts = (ctypes.c_int * 2)()

    def window():
        c.window()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.add_one_capture_edges(stream, counts)
        if rc != 0:
            raise RuntimeError(f"add_one_capture_edges failed: cudaError {rc}")

    c.reset()
    graph, per_replay = common.capture_graph(window)
    c.reset()
    graph.replay()
    common.launches.update(per_replay)
    want = x.clone()
    for _ in range(iters):
        want = want + 1
    err, differing = common.compare_exact([c.sets[iters % 2][0].reshape(1, -1)],
                                          [want.reshape(1, -1)])
    res = dict(edges=counts[0], programmatic=counts[1], max_abs_err=err, differing=differing)
    print(f"add_one graph of {iters} carried PDL launches: {counts[0]} edges, {counts[1]} "
          f"programmatic; the replay vs {iters} torch adds: max abs err {err!r}, {differing} "
          f"elements differ", flush=True)
    if counts[1] == 0:
        raise AssertionError("the captured graph holds no programmatic edge: stream capture did "
                             "not keep the PDL launch attribute")
    if differing:
        raise AssertionError(f"the PDL chain's graph replay differs in {differing} elements")
    return res


def versions() -> Dict[str, str]:
    """The CUDA toolkit the redesign was built with, the runtime's and the
    CUDA driver's versions, as "major.minor"."""
    v = (ctypes.c_int * 3)()
    rc = build.add_one_pdl_library().add_one_versions(v)
    if rc != 0:
        raise RuntimeError(f"add_one_versions failed: cudaError {rc}")
    return {k: f"{x // 1000}.{x % 1000 // 10}" for k, x in zip(("toolkit", "runtime", "driver"), v)}


def add_one_turns(x: torch.Tensor, iters: int, runs: int) -> Dict[str, tuple]:
    """(eager, graph) us per launch of each design on ``x``, in turns (the
    order of ``DESIGNS`` and back), the better of each design's two."""
    order = list(DESIGNS) + list(reversed(DESIGNS))
    times = {name: [] for name in DESIGNS}
    for name in order:
        times[name].append(common.carried_us(DESIGNS[name], (x,), iters, runs))
    return {name: (min(e for e, _ in t), min(g for _, g in t)) for name, t in times.items()}


def chain_lengths(x: torch.Tensor, runs: int) -> Dict[int, dict]:
    """Graphed us per launch of a carried chain of each of ``CHAIN_LENGTHS``
    launches, the redesign with and without PDL, in turns."""
    out = {}
    for n in CHAIN_LENGTHS:
        pdl = [common.carried_us(add_one, (x,), n, runs)[1]]
        nopdl = [common.carried_us(_no_pdl, (x,), n, runs)[1] for _ in range(2)]
        pdl.append(common.carried_us(add_one, (x,), n, runs)[1])
        out[n] = dict(pdl=min(pdl), no_pdl=min(nopdl))
        print(f"  chain of {n:2d}: PDL {out[n]['pdl']:8.3f} us, no PDL {out[n]['no_pdl']:8.3f} us "
              f"per launch ({out[n]['no_pdl'] - out[n]['pdl']:+.3f} us)", flush=True)
    return out


def run(s, n_substeps: int, blocks, iters: int = common.ITERS, runs: int = common.RUNS,
        production: Optional[Dict[str, Callable[[], object]]] = None) -> Dict[str, dict]:
    """Every case on ``blocks`` (K1's q, v, ctrl, dr as ``(rows, B)``).
    Returns, per case: ``eager_us`` and ``graph_us`` per launch; for
    ``add_one`` at each nb the redesign with PDL as ``eager_us`` /
    ``graph_us``, and (eager, graph) of each design under ``designs``
    (``"PDL"``, ``"no PDL"``, ``"one-element"``, ``"torch.add"``), and
    ``numel``; ``"check"``, ``check``'s result; ``"graph"``,
    ``graph_chain``'s at nb = 32; ``"chain"``, ``chain_lengths``' at nb =
    32; under ``"host"`` the host microseconds per call of each layer of
    ``x + 1``'s launch and of each ``production`` path (label -> a call
    making one launch)."""
    dev = blocks[0].device
    print(common.nvidia_smi(), flush=True)
    results = {"versions": versions()}
    print(f"add_one: the redesign {THREADS} threads x {PER_SM} blocks per SM "
          f"({build.add_one_pdl_library().add_one_pdl_grid(THREADS, PER_SM)} blocks), float4, "
          f"PDL; built with CUDA {results['versions']['toolkit']}, runtime "
          f"{results['versions']['runtime']}, CUDA driver {results['versions']['driver']}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    results["check"] = check(dev)
    print(f"launch overhead, {iters} carried launches per window, best of {runs} windows, "
          f"eager and as one CUDA graph (CUDA events), designs in turns:", flush=True)
    for nb in GRIDS:
        x = torch.ones((8 * nb, 8, 128), dtype=torch.float32, device=dev)
        designs = add_one_turns(x, iters, runs)
        results[f"add_one_nb{nb}"] = dict(eager_us=designs["PDL"][0], graph_us=designs["PDL"][1],
                                          designs=designs, numel=x.numel())
        print(f"add_one {tuple(x.shape)}: " + "; ".join(
            f"{name} eager {e:9.3f} us, graph {g:8.3f} us" for name, (e, g) in designs.items())
            + f"; one-element / PDL graphed "
              f"{designs['one-element'][1] / designs['PDL'][1]:.3f}x", flush=True)
    x = torch.ones((8 * GRIDS[-1], 8, 128), dtype=torch.float32, device=dev)
    results["graph"] = graph_chain(x, iters)
    print(f"the graphed chain by length at {tuple(x.shape)}:", flush=True)
    results["chain"] = chain_lengths(x, runs)

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
    fn = build.add_one_pdl_library().add_one_pdl_launch
    args = (x.data_ptr(), y.data_ptr(), x.numel(), THREADS, PER_SM, 1,
            torch.cuda.current_stream(dev).cuda_stream)
    layers = {
        "add_one: C entry point through ctypes": lambda: fn(*args),
        "add_one: build.launch_into": lambda: build.launch_into("add_one", fn, [x, y],
                                                                x.numel(), THREADS, PER_SM, 1),
        "add_one: the wrapper": lambda: add_one(x, y),
        f"{ONE_ELEMENT}: the wrapper": lambda: add_one_one_element(x, y),
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


def sweep(device, iters: int = common.ITERS, runs: int = common.RUNS) -> Dict[tuple, dict]:
    """The redesign's graphed us per launch at each threads per block x
    blocks per SM, with and without PDL, at both nb; the one-element kernel
    timed first and last as the yardstick. Returns (threads, per_sm, nb) ->
    {"pdl", "no_pdl"}."""
    out = {}
    print(f"add_one sweep, graphed us per launch ({iters} carried launches, best of {runs}):",
          flush=True)
    for nb in GRIDS:
        x = torch.ones((8 * nb, 8, 128), dtype=torch.float32, device=device)
        one = [common.carried_us(add_one_one_element, (x,), iters, runs)[1]]
        for threads in SWEEP_THREADS:
            for per_sm in SWEEP_PER_SM:
                def step(a, b, pdl):
                    add_one(a, b, pdl, threads, per_sm)

                res = dict(pdl=common.carried_us(lambda a, b: step(a, b, True), (x,), iters,
                                                 runs)[1],
                           no_pdl=common.carried_us(lambda a, b: step(a, b, False), (x,), iters,
                                                    runs)[1])
                out[(threads, per_sm, nb)] = res
                print(f"  nb={nb:2d} threads {threads:4d} x {per_sm} per SM: PDL "
                      f"{res['pdl']:8.3f} us, no PDL {res['no_pdl']:8.3f} us", flush=True)
        one.append(common.carried_us(add_one_one_element, (x,), iters, runs)[1])
        best = min((k for k in out if k[2] == nb), key=lambda k: out[k]["pdl"])
        print(f"  nb={nb:2d} best with PDL: {best[0]} threads x {best[1]} per SM, "
              f"{out[best]['pdl']:.3f} us; one-element kernel {min(one):.3f} us", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    args = ap.parse_args(argv)
    common.require_cuda("probe_launch_overhead")
    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    s, n_substeps, model = common.nominal_setup(device)
    build.build_in_parallel(build.add_one_pdl_library, build.add_one_library,
                            lambda: build.probe_physics_library(s, n_substeps, None))
    common.print_builds([build.record_name(build.ADD_ONE_PDL), build.record_name(build.ADD_ONE),
                         build.record_name(build.PROBE_PHYSICS, "full")])
    run(s, n_substeps, common.nominal_blocks(s, model, args.envs, device))
    sweep(device)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
