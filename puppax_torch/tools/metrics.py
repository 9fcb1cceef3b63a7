"""Metrics logging: pluggable host-side sinks and the training progress fn.

Counterpart of ``puppax/tools/metrics.py:19-132``: ``MetricsLogger.log``
appends one JSON record per call to the JSONL sink and forwards the
metrics to W&B when a run is live; ``log_artifact`` writes a pointer line
per checkpoint and uploads the directory with ``wandb.log_model``.
``make_progress_fn`` builds the ``progress_fn(step, metrics)`` callback
``ppo.train`` calls, keeping the eval-reward curve and, with
``plot_path``, re-rendering its errorbar PNG (``plot_progress_curve``)
each eval epoch. ``wandb`` and ``matplotlib`` are imported when used.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricsLogger:
    """Fan-out metrics sink. ``log(metrics, step)`` mirrors ``wandb.log``.

    With ``use_wandb`` the W&B sink attaches when ``wandb`` imports and a
    run is live (``wandb.run`` is not None); otherwise only the JSONL sink
    logs."""

    def __init__(self, jsonl_path: Optional[str] = None, use_wandb: bool = False):
        self._jsonl_path = jsonl_path
        self._wandb = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None and wandb.run is not None:
                self._wandb = wandb

    def _append(self, record: Dict) -> None:
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def log(self, metrics: Dict, step: int) -> None:
        record = {"step": step, "ts": time.time()}
        record.update({k: float(v) for k, v in metrics.items() if _is_scalar(v)})
        self._append(record)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_artifact(self, path: str, name: str) -> None:
        """Record a checkpoint directory: a pointer line in the JSONL file,
        and an upload of the directory as a W&B model artifact."""
        self._append({"artifact": name, "path": str(path), "ts": time.time()})
        if self._wandb is not None:
            self._wandb.log_model(path=str(path), name=name)


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def plot_progress_curve(x_data: List, y_data: List, ydataerr: List, path: str,
                        max_y: float = 40.0) -> None:
    """Render the eval-reward errorbar curve to ``path`` (PNG, the Agg
    backend): x the env steps, y the reward per episode, the last reward
    in the title."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.set_xlabel("# environment steps")
    ax.set_ylabel("reward per episode")
    if x_data:
        ax.set_title(f"y={y_data[-1]:.3f}")
        ax.set_ylim([min(0.0, min(y_data)), max(max_y, max(y_data) * 1.25)])
    ax.errorbar(x_data, y_data, yerr=ydataerr)
    fig.savefig(path)
    plt.close(fig)


def make_progress_fn(logger: MetricsLogger, times: Optional[List] = None,
                     x_data: Optional[List] = None, y_data: Optional[List] = None,
                     ydataerr: Optional[List] = None, plot_path: Optional[str] = None):
    """A ``progress_fn(step, metrics)`` that logs the metrics and appends
    the eval-reward curve (steps, reward, reward std); with ``plot_path``
    the curve is re-rendered there each eval epoch (skipped where
    matplotlib is missing)."""
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
            if plot_path is not None:
                try:
                    plot_progress_curve(x_data, y_data, ydataerr, plot_path)
                except ImportError:
                    pass  # matplotlib is an optional host-side extra
        logger.log(metrics, step=num_steps)

    progress.times = times
    progress.x_data = x_data
    progress.y_data = y_data
    progress.ydataerr = ydataerr
    return progress
