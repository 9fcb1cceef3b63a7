"""Metrics logging: the JSONL sink and the training progress fn.

Counterpart of ``puppax/tools/metrics.py:19-132``: ``MetricsLogger.log``
appends one JSON record per call, ``log_artifact`` a pointer line per
checkpoint, and ``make_progress_fn`` builds the ``progress_fn(step,
metrics)`` callback ``ppo.train`` calls, keeping the eval-reward curve.
The W&B sink and the progress plot are not ported (ROADMAP queue 1, tools).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

_ROADMAP_TOOLS = "ROADMAP queue 1, tools"


class MetricsLogger:
    """Metrics sink. ``log(metrics, step)`` mirrors ``wandb.log``."""

    def __init__(self, jsonl_path: Optional[str] = None, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError(f"the W&B sink is not ported yet ({_ROADMAP_TOOLS})")
        self._jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def _append(self, record: Dict) -> None:
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def log(self, metrics: Dict, step: int) -> None:
        record = {"step": step, "ts": time.time()}
        record.update({k: float(v) for k, v in metrics.items() if _is_scalar(v)})
        self._append(record)

    def log_artifact(self, path: str, name: str) -> None:
        """Record a checkpoint directory: a pointer line in the JSONL file."""
        self._append({"artifact": name, "path": str(path), "ts": time.time()})


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def make_progress_fn(logger: MetricsLogger, times: Optional[List] = None,
                     x_data: Optional[List] = None, y_data: Optional[List] = None,
                     ydataerr: Optional[List] = None, plot_path: Optional[str] = None):
    """A ``progress_fn(step, metrics)`` that logs the metrics and appends
    the eval-reward curve (steps, reward, reward std)."""
    if plot_path is not None:
        raise NotImplementedError(f"the progress plot is not ported yet ({_ROADMAP_TOOLS})")
    times = times if times is not None else []
    x_data = x_data if x_data is not None else []
    y_data = y_data if y_data is not None else []
    ydataerr = ydataerr if ydataerr is not None else []

    def progress(num_steps: int, metrics: Dict) -> None:
        times.append(time.time())
        if "eval/episode_reward" in metrics:
            x_data.append(num_steps)
            y_data.append(float(metrics["eval/episode_reward"]))
            ydataerr.append(float(metrics.get("eval/episode_reward_std", 0.0)))
        logger.log(metrics, step=num_steps)

    progress.times = times
    progress.x_data = x_data
    progress.y_data = y_data
    progress.ydataerr = ydataerr
    return progress
