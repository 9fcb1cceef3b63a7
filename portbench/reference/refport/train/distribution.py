"""Tanh-squashed diagonal Gaussian action distribution.

Counterpart of ``puppax/train/distribution.py``: the policy head emits
``2 * action_size`` logits = (loc, scale_param); scale is
``softplus(scale_param) + min_std``, actions are ``tanh`` of a Gaussian
sample, and ``log_prob`` corrects for the squash. Every normal draw is
``jax.random.normal(key, loc.shape)`` from a jax key
(``refport.random``; ``puppax/train/distribution.py:37,70``), or is
given as ``eps``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from refport import random

_MIN_STD = 0.001
_LOG2 = 0.6931471805599453


class NormalTanhDistribution:
    """Stateless helper over policy-head logits of size 2 * event_size."""

    def __init__(self, event_size: int, min_std: float = _MIN_STD):
        self.event_size = event_size
        self.param_size = 2 * event_size
        self._min_std = min_std

    def loc_scale(self, logits: torch.Tensor, dim: int = -1):
        loc, scale = torch.chunk(logits, 2, dim=dim)
        return loc, F.softplus(scale) + self._min_std

    @staticmethod
    def _normal(loc: torch.Tensor, key=None, eps=None) -> torch.Tensor:
        """Standard normal draws shaped like ``loc``: ``eps`` when given (the
        parity tests inject the JAX package's), else from the ``(2,)``
        ``key``."""
        if eps is not None:
            return eps.to(loc.dtype)
        return random.normal(key.to(loc.device), tuple(loc.shape)).to(loc.dtype)

    def sample_no_postprocessing(self, logits: torch.Tensor, key=None,
                                 eps=None) -> torch.Tensor:
        """Pre-tanh sample (what rollouts store for exact log_prob replay)."""
        loc, scale = self.loc_scale(logits)
        return loc + scale * self._normal(loc, key, eps)

    def postprocess(self, pre_tanh: torch.Tensor) -> torch.Tensor:
        return torch.tanh(pre_tanh)

    def mode(self, logits: torch.Tensor) -> torch.Tensor:
        loc, _ = self.loc_scale(logits)
        return torch.tanh(loc)

    def entropy(self, logits: torch.Tensor, key=None, eps=None) -> torch.Tensor:
        """Single-sample entropy estimate of the squashed distribution."""
        loc, scale = self.loc_scale(logits)
        normal_entropy = 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
        pre_tanh = loc + scale * self._normal(loc, key, eps)
        return torch.sum(normal_entropy + self.forward_log_det_jacobian(pre_tanh), dim=-1)

    @staticmethod
    def forward_log_det_jacobian(pre_tanh: torch.Tensor) -> torch.Tensor:
        # log |d tanh(x)/dx| = 2 (log 2 - x - softplus(-2x)), stable for large |x|
        return 2.0 * (_LOG2 - pre_tanh - F.softplus(-2.0 * pre_tanh))

    def log_prob_from(self, loc, scale, pre_tanh, dim: int = -1) -> torch.Tensor:
        """Squashed log density summed over the event axis ``dim``."""
        normal_lp = (
            -0.5 * torch.square((pre_tanh - loc) / scale)
            - torch.log(scale)
            - 0.5 * math.log(2.0 * math.pi)
        )
        return torch.sum(normal_lp - self.forward_log_det_jacobian(pre_tanh), dim=dim)

    def log_prob(self, logits: torch.Tensor, pre_tanh: torch.Tensor) -> torch.Tensor:
        loc, scale = self.loc_scale(logits)
        return self.log_prob_from(loc, scale, pre_tanh)
