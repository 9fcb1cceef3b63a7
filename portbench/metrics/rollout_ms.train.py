"""``rollout_ms.train``: ms per training step of the window between the
CUDA events around the step's unrolls (``FastLane.unroll`` x 2)."""


def read(run):
    return run.window.span_ms.get("pb.rollout")
