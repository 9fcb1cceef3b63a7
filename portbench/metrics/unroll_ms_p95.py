"""``unroll_ms_p95``: the 95th percentile over all unrolls of the window,
each timed from the previous unroll's end event to its own (the first from
the window's start event); no host synchronize inside the window."""

from portbench.harness import percentile


def read(run):
    return percentile(run.window.unit_ms, 95.0)
