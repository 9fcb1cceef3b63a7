"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names its traffic file ``portbench/workloads/<cell>.json``,
which names its configuration and driver. The run builds the system from
the seed, runs the driver's set-up (``setup_s``), measures ``--seconds`` of
back-to-back units of work with CUDA events and no synchronize inside, and,
with ``--trace 1``, then traces a short tail under ``torch.profiler``.
Once the window has closed and the peak memory is read, the program's
state is freed and the plain reference judges the timed path's output.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (units of work in the window), ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, ``breakdown`` (``--trace 1``) and last ``checks``, each number
the check compared beside its limit; the same numbers end standard error.

It exits with 2 and prints no result without a CUDA device, with fewer
devices than the cell asks for, or when a module of JAX or of the JAX
package is loaded. ``--control tf32`` or ``--control bf16`` (the
correctness readings) puts the reference computed in a lower precision in
the program's place (``reference/judge.py``); ``--fault`` plants a fault
for the tests; ``--allow-cpu`` lets the tests drive it on the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(HERE, "reference")]


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("none", "tf32", "bf16"), default="none",
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--allow-cpu", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    try:
        import puppax_torch  # noqa: F401
    except ImportError:
        fail("the program (puppax_torch) is not in this checkout")
    import torch

    from portbench import harness, program, tracing

    cuda = torch.cuda.is_available()
    if not cuda and not args.allow_cpu:
        fail("no CUDA device")
    cell = harness.find_cell(args.workload)
    chips = next(w["chips"] for w in harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
                 ["workloads"] if w["name"] == cell.name)
    if cuda and torch.cuda.device_count() < chips:
        fail(f"{cell.name} asks for {chips} devices, {torch.cuda.device_count()} found")
    if args.fault is not None and args.fault not in program.FAULTS:
        fail(f"unknown fault {args.fault!r}")
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = harness.prepare(cell, args.seed, device, args.fault)
    clock = harness.Clock(cuda)
    setup_s = time.perf_counter() - T0

    drv.clock = clock
    window = harness.run_window(drv.unit, drv.env_steps_per_unit, args.seconds, clock,
                                drv.span_ms)
    drv.clock = None
    trace = None
    if args.trace:
        units = cell.workload["tail_units"]
        trace = tracing.traced(drv.unit, units, clock)
        trace.update(units=units, env_steps=units * drv.env_steps_per_unit)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = harness.Run(cell, window, setup_s, trace)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_window = time.perf_counter()
    numbers, notes = harness.judge(drv, None if args.control == "none" else args.control)
    notes.append(f"seconds: set-up {setup_s:.1f}, window and tail "
                 f"{t_window - T0 - setup_s:.1f}, check {time.perf_counter() - t_window:.1f}")
    correct = all(n.ok for n in numbers)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips if cuda else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.units, "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace is not None:
        device_info.update(busy_s=trace["busy_ms"] / 1000.0, window_s=trace["window_ms"] / 1000.0)
        result["breakdown"] = tracing.breakdown(trace)
    result["checks"] = harness.check_line(numbers)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or of the JAX package are loaded: {found}")
    for line in notes:
        print(line, file=sys.stderr)
    for n in numbers:
        print(f"check {n.name}: {n.value!r} (limit {n.limit!r}) "
              f"{'ok' if n.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
