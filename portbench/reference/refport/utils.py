"""Latency buffers, the latency draw, the activation map and the default
device.

Counterpart of ``puppax/utils.py:40-85``, batched over a leading env axis.
The lag column is the index ``jax.random.choice(p=...)`` draws from the
same key (``random.choice_p``: an inverse CDF on one uniform).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from refport import random


def circular_buffer_push_front(buffer: torch.Tensor, new_value: torch.Tensor) -> torch.Tensor:
    """Shift (..., dim, depth) one column right; write new_value at [..., 0]."""
    return torch.cat([new_value[..., None], buffer[..., :-1]], dim=-1)


def latency_onehot(keys: torch.Tensor, distribution) -> torch.Tensor:
    """(B, depth) one-hot lag columns, one per key of ``keys`` ``(B, 2)``:
    the index ``jax.random.choice(key, depth, p=distribution)`` draws
    (``puppax/utils.py:48-54``)."""
    depth = len(distribution)
    ind = random.choice_p(keys, distribution)
    return F.one_hot(ind.clamp_max(depth - 1), depth).to(torch.float32)


def apply_lagged_value(
    buffer_newest_first: torch.Tensor, new_value: torch.Tensor, onehot: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push new_value, then select the lag column by the one-hot weights
    (0/1 weights select exactly). buffer (..., dim, depth), onehot
    (..., depth). Returns (sampled (..., dim), new buffer)."""
    buf = circular_buffer_push_front(buffer_newest_first, new_value)
    sampled = torch.sum(buf * onehot[..., None, :], dim=-1)
    return sampled, buf


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA device. A CUDA device without a card raises: the CPU runs
    only when the caller asks for ``"cpu"``."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: pass device='cpu' to run the port on the CPU"
        )
    return device if device.index is not None else torch.device("cuda", 0)


def activation_fn_map(activation_name: str):
    """Name -> torch activation (KeyError on unknown names)."""
    return {
        "relu": F.relu,
        "sigmoid": torch.sigmoid,
        "elu": F.elu,
        "tanh": torch.tanh,
        "softmax": lambda x: F.softmax(x, dim=-1),
    }[activation_name.lower()]
