"""Team K3's share of its roofline in the traced tail (%): the frozen
operations and bytes of the configuration's K3 per env step, times the
tail's env steps, at the FP32 peak and HBM bandwidth, over K3's device
time in the trace."""

from portbench.counts import roofline_pct


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run.counts, "k3", run.trace, run.trace["env_steps"])
