"""``setup_s``: seconds from the process's start to the window's start:
imports, the env and the kernels' generation and build (or their load from
the checkout's cache), the networks, the reset and the warm-up units."""


def read(run):
    return run.setup_s
