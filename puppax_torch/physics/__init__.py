"""Physics: the per-env emission of the flat-model step (soa.py)."""
