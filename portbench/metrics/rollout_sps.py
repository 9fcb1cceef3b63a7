"""``rollout_sps``: env steps of every whole unroll in the window over the
window's seconds (CUDA events)."""


def read(run):
    return run.window.env_steps / run.window.seconds
