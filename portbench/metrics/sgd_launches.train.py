"""``sgd_launches.train``: host calls that put work on the device's stream
(kernel launches, async copies and sets) inside the harness's ``pb.sgd``
span, per training step of the traced tail."""


def read(run):
    if run.trace is None or run.trace["units"] == 0:
        return None
    n = run.trace["span_launches"].get("pb.sgd", 0)
    return n / run.trace["units"] if n else None
