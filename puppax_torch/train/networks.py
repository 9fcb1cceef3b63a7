"""Policy/value MLP networks.

Counterpart of ``puppax/train/networks.py``. ``MLP`` keeps the JAX
package's layer naming (``hidden_0``, ``hidden_1``, ...), so a policy's
parameters map one to one onto the flax tree ``{"params": {"hidden_i":
{"kernel", "bias"}}}`` that checkpoints and the export ABI use; flax's
kernel is ``(in, out)`` and ``nn.Linear``'s weight ``(out, in)``
(``params_from_jax`` transposes). Initialization is flax's: LeCun-uniform
kernels and zero biases, drawn from an explicit generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch import nn

from puppax_torch import utils
from puppax_torch.train.distribution import NormalTanhDistribution


class MLP(nn.Module):
    """Plain MLP with ``hidden_i`` layers; no activation after the last."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        activation: str = "elu",
        device=None,
        generator: torch.Generator = None,
    ):
        super().__init__()
        self.layer_sizes = tuple(int(n) for n in layer_sizes)
        self.activation_name = activation
        self.activation: Callable = utils.activation_fn_map(activation)
        fan_in = in_size
        for i, size in enumerate(self.layer_sizes):
            layer = nn.Linear(fan_in, size, device=device)
            with torch.no_grad():
                # flax lecun_uniform: U(-sqrt(3 / fan_in), +sqrt(3 / fan_in))
                bound = math.sqrt(3.0 / fan_in)
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.zero_()
            self.add_module(f"hidden_{i}", layer)
            fan_in = size

    def layers(self):
        return [getattr(self, f"hidden_{i}") for i in range(len(self.layer_sizes))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers()
        for i, layer in enumerate(layers):
            x = layer(x)
            if i != len(layers) - 1:
                x = self.activation(x)
        return x


@dataclass(frozen=True)
class PPONetworks:
    policy_network: MLP  # obs -> 2 * action logits
    value_network: MLP  # obs -> 1
    action_distribution: NormalTanhDistribution


def make_ppo_networks(
    observation_size: int,
    action_size: int,
    policy_hidden_layer_sizes: Sequence[int] = (32, 32, 32, 32),
    value_hidden_layer_sizes: Sequence[int] = (256, 256, 256, 256, 256),
    activation: str = "elu",
    device=None,
    generator: torch.Generator = None,
) -> PPONetworks:
    """Build the policy (obs -> 2 * action logits) and value (obs -> 1)."""
    dist = NormalTanhDistribution(event_size=action_size)
    policy = MLP(observation_size, tuple(policy_hidden_layer_sizes) + (dist.param_size,),
                 activation, device=device, generator=generator)
    value = MLP(observation_size, tuple(value_hidden_layer_sizes) + (1,),
                activation, device=device, generator=generator)
    return PPONetworks(policy_network=policy, value_network=value, action_distribution=dist)


def params_from_jax(flax_params) -> Dict[str, torch.Tensor]:
    """A flax MLP param tree (leaves as numpy; with or without the outer
    ``"params"`` key) as an ``MLP`` state dict."""
    tree = flax_params.get("params", flax_params)
    out = {}
    for name, leaf in tree.items():
        out[f"{name}.weight"] = torch.as_tensor(np.asarray(leaf["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.as_tensor(np.asarray(leaf["bias"], np.float32).copy())
    return out
