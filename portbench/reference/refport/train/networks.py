"""Policy/value MLP networks and the inference-fn factory.

Counterpart of ``puppax/train/networks.py``. ``MLP`` keeps the JAX
package's layer naming (``hidden_0``, ``hidden_1``, ...), so a policy's
parameters map one to one onto the flax tree ``{"params": {"hidden_i":
{"kernel", "bias"}}}`` that checkpoints and the export ABI use; flax's
kernel is ``(in, out)`` and ``nn.Linear``'s weight ``(out, in)``
(``params_from_jax`` transposes). Initialization is flax's, bit for bit:
LeCun-uniform kernels (``jax.nn.initializers.lecun_uniform``:
``uniform(key, (in, out), -1, 1) * sqrt(3 * float32(1 / in))`` in
float32) and zero biases, each kernel drawn from the key flax's
``module.init(key, ...)`` gives it (``flax_param_key``: the module path
and the ``make_rng`` count folded into the key by the first 4 bytes of
their sha1, ``flax/core/scope.py``'s ``_fold_in_static``), so a seed gives
the JAX package's initial weights.

Precision: the policy's products run in full float32 (the JAX package pins
it to ``Precision.HIGHEST``; the fast lane, the export replay and the
policy MLP must agree). The value network's ``value_precision`` is
``"highest"`` (float32) or ``"high"``/``"default"``: TF32 tensor-core
products, switched on inside the value net's own forward and backward
products only, so the process-wide flag (off, ``rollout.FastLane``) never
reaches the policy.
"""

from __future__ import annotations

import contextlib
import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from refport import random, utils
from refport.train import running_statistics
from refport.train.distribution import NormalTanhDistribution

PRECISIONS = ("highest", "high", "default")


@contextlib.contextmanager
def _tf32_products():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _TF32Linear(torch.autograd.Function):
    """``F.linear`` whose forward and backward products run in TF32 on the
    card (the flag is read per product; the CPU ignores it)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with _tf32_products():
            return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
        with _tf32_products():
            gx = g @ w
            gw = g2.t() @ x2
        return gx, gw, g2.sum(0)


def flax_param_key(key: torch.Tensor, path: Sequence[str], count: int) -> torch.Tensor:
    """The key of the ``count``-th ``make_rng("params")`` call in the flax
    module at ``path`` (names below the root) under ``module.init(key,
    ...)``: the path's names and the count (big-endian bytes) hashed by
    sha1, its first 4 bytes big-endian folded into ``key``
    (``flax/core/scope.py``: ``LazyRng`` gathers the suffix, ``push`` adds
    each name, ``make_rng`` the count; ``_fold_in_static`` without the
    ``flax_fix_rng_separator`` bytes, off by default)."""
    m = hashlib.sha1()
    for part in tuple(path) + (int(count),):
        if isinstance(part, str):
            m.update(part.encode("utf-8"))
        else:
            m.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
    return random.fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def lecun_uniform(key: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """``jax.nn.initializers.lecun_uniform()(key, (fan_in, fan_out))``: a
    flax ``(in, out)`` kernel, ``uniform(-1, 1)`` times ``sqrt(3 *
    variance)`` with ``variance = float32(1 / fan_in)``, all in float32
    (``variance_scaling(1, "fan_in", "uniform")``)."""
    scale = np.sqrt(np.float32(3.0) * np.float32(1.0 / fan_in), dtype=np.float32)
    return random.uniform(key, (fan_in, fan_out), -1.0, 1.0) * float(scale)


class MLP(nn.Module):
    """Plain MLP with ``hidden_i`` layers; no activation after the last."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        activation: str = "elu",
        device=None,
        key: torch.Tensor = None,
        precision: str = "highest",
    ):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")
        device = utils.resolve_device(device)
        self.layer_sizes = tuple(int(n) for n in layer_sizes)
        self.activation_name = activation
        self.activation: Callable = utils.activation_fn_map(activation)
        self.precision = precision
        key = random.key(0, device) if key is None else key.to(device)
        fan_in = in_size
        for i, size in enumerate(self.layer_sizes):
            layer = nn.Linear(fan_in, size, device=device)
            with torch.no_grad():
                # the Dense's kernel is its scope's first make_rng("params")
                layer.weight.copy_(lecun_uniform(flax_param_key(key, (f"hidden_{i}",), 1),
                                                 fan_in, size).t())
                layer.bias.zero_()
            self.add_module(f"hidden_{i}", layer)
            fan_in = size

    def layers(self):
        return [getattr(self, f"hidden_{i}") for i in range(len(self.layer_sizes))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers()
        for i, layer in enumerate(layers):
            if self.precision == "highest":
                x = layer(x)
            else:
                x = _TF32Linear.apply(x, layer.weight, layer.bias)
            if i != len(layers) - 1:
                x = self.activation(x)
        return x


def _normalized(normalizer, obs):
    return obs if normalizer is None else running_statistics.normalize(obs, normalizer)


@dataclass(frozen=True)
class PPONetworkParams:
    """The policy and value parameters (``params[1].policy`` is part of the
    callback surface, as in the JAX package)."""

    policy: MLP
    value: MLP


@dataclass(frozen=True)
class PPONetworks:
    policy_network: MLP  # obs -> 2 * action logits
    value_network: MLP  # obs -> 1
    action_distribution: NormalTanhDistribution

    def policy_apply(self, normalizer, obs: torch.Tensor) -> torch.Tensor:
        """Policy logits of (normalized) observations."""
        return self.policy_network(_normalized(normalizer, obs))

    def value_apply(self, normalizer, obs: torch.Tensor) -> torch.Tensor:
        """The value of (normalized) observations, the last axis squeezed."""
        return self.value_network(_normalized(normalizer, obs)).squeeze(-1)

    @property
    def params(self) -> PPONetworkParams:
        return PPONetworkParams(policy=self.policy_network, value=self.value_network)


def make_ppo_networks(
    observation_size: int,
    action_size: int,
    policy_hidden_layer_sizes: Sequence[int] = (32, 32, 32, 32),
    value_hidden_layer_sizes: Sequence[int] = (256, 256, 256, 256, 256),
    activation: str = "elu",
    device=None,
    key: torch.Tensor = None,
    value_precision: str = "highest",
    privileged_size: int = 0,
) -> PPONetworks:
    """Build the policy (obs -> 2 * action logits) and value (obs -> 1),
    their weights drawn from the two halves of ``split(key)``
    (``puppax/train/ppo.py:591``; ``key`` defaults to ``PRNGKey(0)``). ``privileged_size``
    widens the value network's input alone to ``observation_size +
    privileged_size`` (the privileged critic); the policy and the export
    ABI stay as they are."""
    device = utils.resolve_device(device)
    dist = NormalTanhDistribution(event_size=action_size)
    key = random.key(0, device) if key is None else key.to(device)
    key_policy, key_value = random.split(key).unbind(0)
    policy = MLP(observation_size, tuple(policy_hidden_layer_sizes) + (dist.param_size,),
                 activation, device=device, key=key_policy)
    value = MLP(observation_size + int(privileged_size), tuple(value_hidden_layer_sizes) + (1,),
                activation, device=device, key=key_value, precision=value_precision)
    return PPONetworks(policy_network=policy, value_network=value, action_distribution=dist)


def make_inference_fn(networks: PPONetworks):
    """``make_policy((normalizer, policy MLP), deterministic=False)`` ->
    ``policy(obs, key=None, eps=None) -> (action, extras)``: the tanh of
    the mode, or a NormalTanh sample from the ``(2,)`` ``key`` (or the
    given normal draws ``eps``) with its log_prob and pre-tanh action."""
    dist = networks.action_distribution

    def make_policy(params, deterministic: bool = False):
        normalizer, policy_net = params

        def policy(obs: torch.Tensor, key: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None):
            logits = policy_net(_normalized(normalizer, obs))
            if deterministic:
                return dist.mode(logits), {}
            pre_tanh = dist.sample_no_postprocessing(logits, key, eps)
            return dist.postprocess(pre_tanh), {
                "log_prob": dist.log_prob(logits, pre_tanh),
                "raw_action": pre_tanh,
            }

        return policy

    return make_policy


def params_from_jax(flax_params) -> Dict[str, torch.Tensor]:
    """A flax MLP param tree (leaves as numpy; with or without the outer
    ``"params"`` key) as an ``MLP`` state dict."""
    tree = flax_params.get("params", flax_params)
    out = {}
    for name, leaf in tree.items():
        out[f"{name}.weight"] = torch.as_tensor(np.asarray(leaf["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.as_tensor(np.asarray(leaf["bias"], np.float32).copy())
    return out
