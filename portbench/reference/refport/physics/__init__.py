"""Physics: the pipeline (smooth, collision, constraint, solver) and the
model's static digest for the row layouts (soa.py)."""
