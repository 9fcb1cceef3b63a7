"""``mfu.rollout``: the unrolls' share of the FP32 peak (%) over the
untraced window: the frozen K3 operations and a policy forward pass per
env step."""

from portbench.counts import mfu_pct, rollout_flops


def read(run):
    return mfu_pct(rollout_flops(run.counts, run.window.env_steps), run.window.seconds)
