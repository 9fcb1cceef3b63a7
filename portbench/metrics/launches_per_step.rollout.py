"""``launches_per_step.rollout``: device activities (kernels, copies, sets)
per env step of the traced unrolls."""


def read(run):
    if run.trace is None or run.trace["env_steps"] == 0:
        return None
    n = sum(run.trace["launches"].values())
    return n / run.trace["env_steps"] if n else None
