"""``sgd_ms.train``: ms per training step of the window between the CUDA
events around the step's ``sgd_pass`` calls."""


def read(run):
    return run.window.span_ms.get("pb.sgd")
