"""The benchmark's general part: find a cell's files by name, time its
window, trace its tail, judge its output and print the result line.

Nothing here names a cell, a configuration or a metric. A cell is an entry
of ``BENCHMARK.json``'s ``workloads``; its traffic is
``portbench/workloads/<cell>.json``, which names its configuration
(``portbench/configs/<config>.json``) and its driver
(``portbench/drivers/<driver>.py``); each metric is read by
``portbench/metrics/<metric>.py``. A later change adds files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "puppax")
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): FP32 outside
# the tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A driver or a metric reader, imported from its file."""
    name = "portbench_" + os.path.relpath(path, BENCH).replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell's files, found by its name."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    driver: Any
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, bench: str = BENCH) -> Cell:
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    workload = load_json(os.path.join(bench, "workloads", f"{name}.json"))
    if workload["config"] != entries[name]["config"]:
        raise SystemExit(f"{name}: BENCHMARK.json names config {entries[name]['config']!r}, "
                         f"its workload file {workload['config']!r}")
    config = load_json(os.path.join(bench, "configs", f"{workload['config']}.json"))
    driver = load_module(os.path.join(bench, "drivers", f"{workload['driver']}.py"))
    return Cell(name, workload, config, driver,
                [m for m in manifest["end_to_end"] if applies(m, name)],
                [m for m in manifest["per_layer"] if applies(m, name)])


def reader(metric: str, bench: str = BENCH) -> Callable:
    return load_module(os.path.join(bench, "metrics", f"{metric}.py")).read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``puppax_torch`` is the port)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ---- a run's set-up and check ---------------------------------------------


def prepare(cell: Cell, seed: int, device, fault: Optional[str] = None):
    """The cell's driver built from the seed on ``device``, its set-up run
    (the shapes warmed up, the checked steps of a training cell driven)."""
    from portbench import program

    drv = cell.driver.make(program.Context(cell.config, cell.workload, seed, device, fault))
    drv.warm()
    Clock(device.type == "cuda").sync()
    return drv


def judge(drv, control: Optional[str] = None):
    """Free the program's state, then run the check: (numbers, notes)."""
    import torch

    drv.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return drv.check(control=control)


# ---- clocks -------------------------------------------------------------


class Clock:
    """Marks on the device's stream (CUDA events), or the host clock where
    a test drives the harness on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1000.0

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()


@dataclass
class Window:
    """What the measured window gives the readers: its length, every unit
    of work's time (from the previous unit's end mark to its own; the first
    from the window's start mark), the env steps of the whole units and the
    driver's spans summed over the window."""

    seconds: float
    unit_ms: List[float]
    env_steps: int
    span_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def units(self) -> int:
        return len(self.unit_ms)


def run_window(work: Callable[[int], None], env_steps_per_unit: int, seconds: float,
               clock: Clock, spans: Optional[Callable[[], Dict[str, float]]] = None) -> Window:
    """Call ``work(i)`` back to back until ``seconds`` have passed on the
    host clock, with no synchronize inside, then read the marks."""
    clock.sync()
    start = clock.mark()
    ends = []
    t0 = time.perf_counter()
    i = 0
    while True:
        work(i)
        ends.append(clock.mark())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    marks = [start] + ends
    unit_ms = [clock.ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
    return Window(seconds=clock.ms(start, ends[-1]) / 1000.0, unit_ms=unit_ms,
                  env_steps=env_steps_per_unit * len(ends),
                  span_ms=spans() if spans is not None else {})


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile of all values, linear between ranks
    (``numpy.percentile``'s default)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---- the run record the readers see --------------------------------------


@dataclass
class Run:
    cell: Cell
    window: Window
    setup_s: float
    trace: Optional[Dict[str, Any]] = None  # the traced tail's summary

    @property
    def counts(self) -> Dict[str, Any]:
        return self.cell.config["frozen_counts"]


@dataclass
class Number:
    """One number compared by the correctness check, with its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def check_line(numbers: List[Number]) -> Dict[str, Dict[str, float]]:
    return {n.name: {"value": n.value, "limit": n.limit} for n in numbers}
