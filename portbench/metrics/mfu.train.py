"""``mfu.train``: the whole training step's share of the FP32 peak (%) over
the untraced window: the frozen K3 operations and a policy forward pass per
env step, plus SGD's forward and backward passes of both networks."""

from portbench.counts import mfu_pct, rollout_flops, sgd_flops


def read(run):
    train = run.cell.config["experiment"]["train"]
    steps = run.window.units
    flops = rollout_flops(run.counts, run.window.env_steps) + steps * sgd_flops(run.counts, train)
    return mfu_pct(flops, run.window.seconds)
