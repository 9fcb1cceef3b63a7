"""Checkpoint save/restore in the ``<checkpoint_path>/<step>/`` layout.

Counterpart of ``puppax/train/checkpoint.py:20-81``. The JAX package writes
orbax directories; the port writes one ``torch.save`` file,
``<checkpoint_path>/<step>/checkpoint.pt``, of a tree of dicts, lists,
tensors and numbers, and reads it back with ``weights_only=True``
(``scripts/export_policy.py`` exports it).

``save_jax_params`` writes a JAX package's params tree, ``(normalizer,
PPONetworkParams)`` as its training CLI saves it, given as nested numpy
arrays, in the port's layout: the top-level script
``convert_orbax_checkpoint.py`` reads the orbax directory where JAX lives
and calls it, so this package never imports orbax or JAX. A JAX train
state (optax's Adam state) is not carried across. ``download_checkpoint``
(W&B) belongs to ROADMAP queue 1's tools item.

No key is saved: the JAX package's train state (``puppax/train/ppo.py``'s
``TrainingState``: optimizer state, params, normalizers, env steps)
carries none, and a resumed run, there as here, starts its key tree anew
from the seed (``ppo.init_keys``) and resets its envs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from puppax_torch.train import networks

FILE = "checkpoint.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(current_step: int, tree: Any, checkpoint_path) -> str:
    """Save ``tree`` (its tensors copied to the CPU) under
    ``checkpoint_path/<step>/``; returns that directory."""
    path = (Path(checkpoint_path) / str(int(current_step))).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f".{FILE}.{os.getpid()}.tmp"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, path / FILE)
    return str(path)


def latest_checkpoint_step(checkpoint_path) -> Optional[int]:
    """Highest-step subdirectory holding a checkpoint, or None."""
    p = Path(checkpoint_path)
    if not p.is_dir():
        return None
    steps = [int(d.name) for d in p.iterdir()
             if d.is_dir() and d.name.isdigit() and (d / FILE).exists()]
    return max(steps) if steps else None


def restore_checkpoint(checkpoint_path, step: Optional[int] = None, map_location=None):
    """The tree saved at ``step`` (default: the latest), its tensors on
    ``map_location`` (default: the CPU)."""
    if step is None:
        step = latest_checkpoint_step(checkpoint_path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {checkpoint_path}")
    path = (Path(checkpoint_path) / str(int(step)) / FILE).resolve()
    return torch.load(path, map_location=map_location, weights_only=True)


def save_jax_params(current_step: int, params, checkpoint_path) -> str:
    """Save a JAX params tree, ``(normalizer, PPONetworkParams)`` as orbax
    restores it (dicts of numpy leaves), as the tree ``ppo.params_state_dict``
    writes: the normalizer's four fields, and the policy's and the value
    net's flax trees as ``MLP`` state dicts (``networks.params_from_jax``; a
    privileged critic's wider value net maps the same way). Returns
    ``checkpoint_path/<step>/``."""
    normalizer, nets = params
    tree = {
        "normalizer": {name: torch.tensor(np.asarray(normalizer[name], np.float32))
                       for name in ("count", "mean", "summed_variance", "std")},
        "policy": networks.params_from_jax(nets["policy"]),
        "value": networks.params_from_jax(nets["value"]),
    }
    return save_checkpoint(current_step, tree, checkpoint_path)
