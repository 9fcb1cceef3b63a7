"""``train_sps``: env steps of every whole training step in the window over
the window's seconds (CUDA events at the window's start and after its
last step)."""


def read(run):
    return run.window.env_steps / run.window.seconds
