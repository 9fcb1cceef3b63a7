"""Tracing and timing on the card.

Counterpart of ``puppax/tools/profiling.py``: ``trace(log_dir, name)``
wraps a block in ``torch.profiler.profile`` (CUDA activity recorded
where the card is in use), puts it under ``record_function(name)``,
writes a Chrome / TensorBoard trace (``*.pt.trace.json``) into
``log_dir`` and summarizes the device's side of it (``summarize``);
``Timer`` measures steady-state steps/s with a device fence.

    with profiling.trace("traces", "update") as tr:
        ...
    tr.summary["idle"], tr.summary["launches"], tr.path

Device busy time is the union of every device activity interval of the
trace (kernels, copies, sets), the window the block's time (CUDA events
on the card, the host clock elsewhere), and ``idle = 1 - busy / window``.
The profiler's host overhead stretches a traced window, so its idle share
is an upper bound on the untraced block's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional


def _device_events(events) -> list:
    """The device activities of a trace: its CUDA events without the device
    spans of ``record_function`` regions (user annotations), which cover
    the region whether the device is busy or not."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_us(events) -> float:
    """Length of the union of the device activity intervals of a trace."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in _device_events(events))
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def summarize(events, window_ms: float) -> Dict[str, Any]:
    """A trace's device side: ``launches`` (device activities by name:
    kernels, copies, sets), ``device_us`` (their device time by name), the
    busy ms (``device_busy_us``), the window ms and ``idle = 1 - busy /
    window``."""
    launches: Dict[str, int] = {}
    device_us: Dict[str, float] = {}
    for e in _device_events(events):
        launches[e.name] = launches.get(e.name, 0) + 1
        device_us[e.name] = device_us.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy_ms = device_busy_us(events) / 1000.0
    return {"launches": launches, "device_us": device_us, "busy_ms": busy_ms,
            "window_ms": window_ms, "idle": 1.0 - busy_ms / window_ms}


@dataclasses.dataclass
class Trace:
    """What ``trace`` gives its caller: the profile, the trace file, whether
    the block ran on the card (its window then CUDA events', else the host
    clock's) and, once the block has ended, its ``summarize``."""

    profile: Any
    path: str
    on_card: bool
    summary: Optional[Dict[str, Any]] = None


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None, device=None):
    """Trace the enclosed block with ``torch.profiler`` into ``log_dir``.

    ``device`` is the device the block runs on (default: the card where
    there is one). On the card the trace records CUDA activity, the window
    is timed with CUDA events and the block is synchronized before the
    profile closes; a trace that then holds no device event raises, and
    no file is written. View the file with TensorBoard's profile plugin or
    Perfetto; trace a few steady-state steps, not the first call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    label = name or "trace"
    path = os.path.join(log_dir, f"{label}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    span = record_function(name) if name is not None else contextlib.nullcontext()
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        result = Trace(profile=prof, path=path, on_card=on_card)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        with span:
            yield result
        if on_card:
            end.record()
            torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) if on_card else (time.perf_counter() - t0) * 1000.0
    result.summary = summarize(prof.events(), window_ms)
    if on_card and not result.summary["launches"]:
        raise RuntimeError(f"trace {label!r}: the block ran on the card and the trace holds "
                           f"no device event (CUPTI recorded nothing)")
    prof.export_chrome_trace(path)


def _fence(tree) -> None:
    """Synchronize the CUDA device of every tensor leaf of ``tree`` (dicts,
    lists, tuples and dataclasses walked)."""
    import torch

    devices = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    for d in devices:
        torch.cuda.synchronize(d)


class Timer:
    """Phase timer with device fencing; accumulates per-phase durations."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time a block; on exit the CUDA device of every tensor leaf of
        ``fence`` is synchronized before the clock is read, so the device
        work is included."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            self.durations.setdefault(name, []).append(time.perf_counter() - t0)

    def steps_per_sec(self, name: str, steps_per_call: int) -> float:
        """Steady-state throughput of a phase (drops the first, cold call)."""
        times = self.durations.get(name, [])
        times = times[1:] if len(times) > 1 else times
        if not times:
            return 0.0
        return steps_per_call * len(times) / sum(times)

    def summary(self) -> Dict[str, float]:
        """The mean duration (s) of each phase."""
        return {name: sum(times) / len(times) for name, times in self.durations.items()}
