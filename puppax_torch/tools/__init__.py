"""puppax_torch.tools: host-side tools around the port (off the hot path).

The counterparts of ``puppax/tools``: the metrics sinks and the progress
fn (``metrics``: JSONL, W&B, the progress plot), policy visualization
(``eval``: a scripted rollout on the card, recorded and rendered),
rendering and video writing (``video``), gait plotting (``plotting``) and
tracing and timing on the card (``profiling``); and the port's own
measurement CLIs, ``profile_unroll`` (where an unroll's time goes on the
card) and ``rank_scaling`` (N ranks against one process).
"""

from puppax_torch.tools.metrics import MetricsLogger, make_progress_fn  # noqa: F401
