"""Tanh-squashed diagonal Gaussian action distribution.

Counterpart of ``puppax/train/distribution.py``: the policy head emits
``2 * action_size`` logits = (loc, scale_param); scale is
``softplus(scale_param) + min_std``, actions are ``tanh`` of a Gaussian
sample, and ``log_prob`` corrects for the squash.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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

    def postprocess(self, pre_tanh: torch.Tensor) -> torch.Tensor:
        return torch.tanh(pre_tanh)

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
