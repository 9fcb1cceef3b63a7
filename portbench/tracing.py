"""The traced tail: ``torch.profiler`` over a few units of work, reduced
to what the per-layer readers and the result's ``breakdown`` need.

The device-event filter and the busy-time union are copied from
``puppax_torch/tools/profiling.py`` (``summarize``, ``device_busy_us``): busy time
is the union of every device activity interval (kernels, copies, sets),
without the device spans of ``record_function`` regions, which cover a
region whether the device works or not. The harness's own spans
(``record_function`` names starting ``pb.``) split the host's side: the
launches issued inside each span, and the idle gaps of the device by the
innermost span the host was in when the gap began.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, List, Tuple

SPAN_PREFIX = "pb."
# host calls that put work on the device's stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


def device_events(events) -> list:
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_intervals(events) -> List[Tuple[float, float]]:
    """The union of the device activity intervals, merged, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(events))
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events, window_ms: float) -> Dict[str, Any]:
    """The tail's device side and the host's spans: device activities and
    device time by name, busy and window ms, launches issued inside each
    ``pb.`` span, and the idle gaps by span."""
    from torch.autograd import DeviceType

    launches: Dict[str, int] = {}
    device_us: Dict[str, float] = {}
    for e in device_events(events):
        launches[e.name] = launches.get(e.name, 0) + 1
        device_us[e.name] = device_us.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                    if e.name.startswith(SPAN_PREFIX)), key=lambda x: x[0])
    span_launches: Dict[str, int] = {}
    for e in cpu:
        if e.name in LAUNCH_CALLS:
            for s, t, name in spans:
                if s <= e.time_range.start <= t:
                    span_launches[name] = span_launches.get(name, 0) + 1
    busy = busy_intervals(events)
    gaps = []
    starts = [s for s, _, _ in spans]
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        gaps.append((b - a, _innermost(spans, starts, a)))
    by_span: Dict[str, float] = {}
    for g, name in gaps:
        by_span[name] = by_span.get(name, 0.0) + g
    busy_ms = sum(e - s for s, e in busy) / 1000.0
    return {
        "launches": launches,
        "device_us": device_us,
        "busy_ms": busy_ms,
        "window_ms": window_ms,
        "span_launches": span_launches,
        "idle_by_span_us": by_span,
    }


def _innermost(spans, starts, t: float) -> str:
    """The shortest harness span that holds host time ``t``, or ``host``."""
    best, best_len = "host", None
    for s, e, name in spans[: bisect.bisect_right(starts, t)]:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def breakdown(summary: Dict[str, Any]) -> Dict[str, list]:
    """The result's ``breakdown``: the 10 device operations that took most
    time and the idle gaps summed by the span the host was in, in s."""
    ops = sorted(summary["device_us"].items(), key=lambda kv: kv[1], reverse=True)[:10]
    gaps = sorted(summary["idle_by_span_us"].items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[name, us / 1e6] for name, us in ops],
            "idle_gaps": [[name, us / 1e6] for name, us in gaps]}


def traced(work: Callable[[int], None], units: int, clock):
    """Run ``units`` units of work under ``torch.profiler`` (CPU and CUDA
    activity) and return ``summarize`` of it."""
    from torch.profiler import ProfilerActivity, profile

    clock.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = clock.mark()
        for i in range(units):
            work(i)
        end = clock.mark()
        clock.sync()
    return summarize(prof.events(), clock.ms(start, end))
