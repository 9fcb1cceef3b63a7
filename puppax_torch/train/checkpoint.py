"""Checkpoint save/restore in the ``<checkpoint_path>/<step>/`` layout.

Counterpart of ``puppax/train/checkpoint.py:20-81``. The JAX package writes
orbax directories; the port writes one ``torch.save`` file,
``<checkpoint_path>/<step>/checkpoint.pt``, of a tree of dicts, lists,
tensors and numbers, and reads it back with ``weights_only=True``
(``scripts/export_policy.py`` exports it).

``save_jax_params`` writes a JAX package's params tree, ``(normalizer,
PPONetworkParams)`` as its training CLI saves it, given as nested numpy
arrays, in the port's layout, and ``save_jax_train_state`` a JAX train
state (``puppax/train/ppo.py``'s ``TrainingState`` as orbax restores it:
optax's state, the params, the normalizers, the two-limb env-step count)
as the tree ``ppo.TrainingState.load_state_dict`` resumes from: the
top-level script ``convert_orbax_checkpoint.py`` reads the orbax
directory where JAX lives and calls them, so this package never imports
orbax or JAX. ``download_checkpoint`` fetches the latest checkpoint
artifact of a W&B run: the directories the training CLI uploads through
``MetricsLogger.log_artifact``, which ``restore_checkpoint`` reads.

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


def download_checkpoint(project_name: str, entity_name: str, run_number: int,
                        save_path="checkpoint") -> str:
    """Fetch the highest-step checkpoint artifact of a W&B run: the run
    whose name ends in ``-<run_number>``, then its ``checkpoint_*_<step>``
    artifact of the largest step. Raises ``LookupError`` for no such run or
    no checkpoint artifact, and ``ImportError`` without ``wandb``. The
    artifact is a directory the training CLI saved (``save_checkpoint``);
    it lands in ``save_path/<step>/``, so ``restore_checkpoint(save_path)``
    reads it. Returns ``save_path``."""
    import wandb

    api = wandb.Api()
    runs = [r for r in api.runs(f"{entity_name}/{project_name}")
            if r.name.endswith(f"-{run_number}")]
    if not runs:
        raise LookupError(f"no run ending in -{run_number}")
    artifacts = [a for a in runs[0].logged_artifacts() if "checkpoint" in a.name]
    if not artifacts:
        raise LookupError("run has no checkpoint artifacts")

    def step(a):
        return int(a.name.split("_")[-1].split(":")[0])

    latest = max(artifacts, key=step)
    latest.download(str(Path(save_path) / str(step(latest))))
    return str(save_path)


def restore_checkpoint(checkpoint_path, step: Optional[int] = None, map_location=None):
    """The tree saved at ``step`` (default: the latest), its tensors on
    ``map_location`` (default: the CPU)."""
    if step is None:
        step = latest_checkpoint_step(checkpoint_path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {checkpoint_path}")
    path = (Path(checkpoint_path) / str(int(step)) / FILE).resolve()
    return torch.load(path, map_location=map_location, weights_only=True)


def _normalizer_from_jax(normalizer) -> dict:
    return {name: torch.tensor(np.asarray(normalizer[name], np.float32))
            for name in ("count", "mean", "summed_variance", "std")}


def _layers(flax_params):
    """A flax MLP's ``hidden_i`` layers in order (``i`` as a number)."""
    tree = flax_params.get("params", flax_params)
    return [tree[name] for name in sorted(tree, key=lambda n: int(n.rsplit("_", 1)[1]))]


def _adam_order(tree) -> list:
    """A flax ``PPONetworkParams`` tree's leaves in ``ppo.Adam.params``'
    order (the policy's ``parameters()``, then the value net's: per layer
    the ``(out, in)`` weight, then the bias)."""
    out = []
    for net in ("policy", "value"):
        for layer in _layers(tree[net]):
            out.append(torch.tensor(np.asarray(layer["kernel"], np.float32).T.copy()))
            out.append(torch.tensor(np.asarray(layer["bias"], np.float32)))
    return out


def _adam_state(optimizer_state) -> dict:
    """optax's state as orbax restores it, ``adam`` alone ``[adam, lr]`` or
    ``chain(clip_by_global_norm, adam)`` ``[None, [adam, lr]]`` (the clip's
    and a constant lr's ``EmptyState`` restore as None, a schedule's as
    ``{"count"}``), as ``ppo.Adam.state_dict()``'s tree."""
    opt = list(optimizer_state)
    if len(opt) == 2 and opt[0] is None and isinstance(opt[1], (list, tuple)):
        opt = list(opt[1])  # the clip's empty state, then adam's chain
    adam = opt[0] if len(opt) == 2 else None
    if not (isinstance(adam, dict) and set(adam) == {"count", "mu", "nu"}):
        raise ValueError("the optimizer state is not optax's adam (or clip_by_global_norm "
                         "then adam): the port's Adam cannot take it")
    count = int(np.asarray(adam["count"]))
    lr = opt[1]
    if lr is not None and int(np.asarray(lr["count"])) != count:
        raise ValueError(f"the lr schedule's count {int(np.asarray(lr['count']))} is not "
                         f"adam's {count}: the port reads both at one count")
    return {"count": count, "mu": _adam_order(adam["mu"]), "nu": _adam_order(adam["nu"])}


def save_jax_train_state(current_step: int, state, checkpoint_path) -> str:
    """Save a JAX train state (``puppax/train/ppo.py``'s ``TrainingState``
    as orbax restores it: a dict of numpy leaves) as the tree
    ``ppo.TrainingState.state_dict`` writes, under
    ``checkpoint_path/<step>/``: optax's Adam ``count``, ``mu`` and
    ``nu`` in ``ppo.Adam.params``' order (``_adam_state``), the policy's
    and value net's params, the observation normalizer, the critic
    normalizer where there is one, and the env-step count ``hi * 2**30 +
    lo``. ``ppo.train(checkpoint_dir=<out>, resume=True)`` resumes from
    ``<out>/state/``."""
    steps = state["env_steps"]
    env_steps = (int(np.asarray(steps["hi"])) * 2**30 + int(np.asarray(steps["lo"])))
    nets = state["params"]
    tree = {
        "params": {
            "normalizer": _normalizer_from_jax(state["normalizer_params"]),
            "policy": networks.params_from_jax(nets["policy"]),
            "value": networks.params_from_jax(nets["value"]),
        },
        "optimizer": _adam_state(state["optimizer_state"]),
        "env_steps": env_steps,
    }
    if state.get("critic_normalizer_params") is not None:
        tree["critic_normalizer"] = _normalizer_from_jax(state["critic_normalizer_params"])
    return save_checkpoint(current_step, tree, checkpoint_path)


def save_jax_params(current_step: int, params, checkpoint_path) -> str:
    """Save a JAX params tree, ``(normalizer, PPONetworkParams)`` as orbax
    restores it (dicts of numpy leaves), as the tree ``ppo.params_state_dict``
    writes: the normalizer's four fields, and the policy's and the value
    net's flax trees as ``MLP`` state dicts (``networks.params_from_jax``; a
    privileged critic's wider value net maps the same way). Returns
    ``checkpoint_path/<step>/``."""
    normalizer, nets = params
    tree = {
        "normalizer": _normalizer_from_jax(normalizer),
        "policy": networks.params_from_jax(nets["policy"]),
        "value": networks.params_from_jax(nets["value"]),
    }
    return save_checkpoint(current_step, tree, checkpoint_path)
