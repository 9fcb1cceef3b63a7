"""The batched env State.

Counterpart of ``puppax/env/base.py``. Every field has a leading env axis.
``PupperV3Env.step`` fills ``pipeline_state`` with the last forward pass's
caches (``physics/pipeline.py::PhysicsState``, re-exported here) of
``pipeline_step``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from refport.physics.pipeline import PhysicsState

__all__ = ["PhysicsState", "State"]


@dataclass(frozen=True)
class State:
    """Batched environment state: qpos (B, nq), qvel (B, nv), obs (B, obs),
    reward (B,), done (B,), metrics and info dicts of (B, ...) tensors, and
    the physics caches of the standard lane (None on fast-lane states)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]
    pipeline_state: Optional[PhysicsState] = None

    def replace(self, **updates) -> "State":
        return dataclasses.replace(self, **updates)
