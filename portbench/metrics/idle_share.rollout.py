"""The device's idle share of the traced tail (%): one less the union of
the device activity intervals over the tail's window (CUDA events)."""


def read(run):
    if run.trace is None or run.trace["window_ms"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_ms"] / run.trace["window_ms"])
