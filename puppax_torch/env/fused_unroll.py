"""The fused unroll (K4): T policy steps and wrapped env steps in one launch.

Counterpart of ``puppax/env/fused_unroll.py``. One step of the unroll is

* the policy observation: the history rows of the carried env block, and
  the gait clock's (cos, sin) of the carried phase when it is on;
* the policy MLP with the observation normalizer folded into its first
  layer (``fold_normalizer``) and the NormalTanh head (``policy_math``)
  on the pre-drawn sampling eps;
* the wrapped env step (the K3 emission, ``soa_env._emit_wrapped_step``);
* the gait clock's tick, restarted on the effective done.

``unroll_rows`` is the plain version: every value a ``(rows, B)`` torch
tensor, and every sum spelled in the kernel's order (the MLP's dot products
and the log-prob's sum over the actions run term by term, never as
``torch.matmul`` or ``torch.sum``, which reduce in other orders on CUDA),
so that the kernel and the plain version agree bit for bit on the card.
``unroll`` is the wrapper: CPU tensors run ``unroll_rows``, CUDA tensors
launch team K4 (``csrc/fused_unroll_team.cuh``: 32 envs per block, K3's
program and the MLP split across the block's warps,
``kernels/cgen.py::fused_unroll_team_body``) or raise. The one-thread K4
(``csrc/fused_unroll.cuh`` around the K3 body, one env per thread) stays
as the A/B baseline, ``unroll_one_thread``; nothing on the main path calls
it. ``kernel_call`` allocates a K4 launch's outputs and passes its
pointers, for both kernels and for their g++ builds in the tests.

Every block is ``(rows, B)`` float32; the per-step inputs (env noise,
sampling eps) and outputs (observation, action, raw action, log-prob, aux)
are ``(T, rows, B)``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from puppax_torch.env import soa_env
from puppax_torch.kernels import build

# hidden activations, in the order of the kernel's runtime codes
ACTIVATIONS = ("elu", "relu", "tanh", "sigmoid", "softmax")
MAX_LAYERS = 8  # csrc/fused_policy.cuh K4_MAX_LAYERS
MAX_WIDTH = 512  # csrc/fused_policy.cuh K4_MAX_WIDTH
MIN_STD = 0.001
LOG2 = 0.6931471805599453
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
SOFTPLUS_THRESHOLD = 20.0  # torch.nn.functional.softplus's default

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


def fold_normalizer(normalizer, policy) -> Layers:
    """(normalizer state or None, policy ``MLP``) -> ``[(W_t (out, in), b
    (out,))]`` float32, the running statistics folded into layer 0
    (``fused_unroll.py:63-86``): ``W0' = W0 / std``, ``b0' = b0 - W0' @ mean``."""
    layers = []
    for i, layer in enumerate(policy.layers()):
        w_t = layer.weight.detach().to(torch.float32)
        b = layer.bias.detach().to(torch.float32)
        if i == 0 and normalizer is not None:
            w_t = w_t / normalizer.std.to(torch.float32)[None, :]
            b = b - torch.mv(w_t, normalizer.mean.to(torch.float32))
        layers.append((w_t.contiguous(), b.contiguous()))
    return layers


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus``'s formula, spelled as the kernel spells it."""
    return torch.where(x > SOFTPLUS_THRESHOLD, x, torch.log1p(torch.exp(x)))


def activate(activation: str, x: torch.Tensor) -> torch.Tensor:
    """A hidden activation on feature-major ``(n, B)`` rows, as the kernel
    computes it; softmax runs over the n features, in order."""
    if activation == "elu":  # jax.nn.elu's expm1 form
        return torch.where(x > 0, x, torch.expm1(x))
    if activation == "relu":
        return torch.where(x > 0, x, torch.zeros_like(x))
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "sigmoid":
        return torch.ones_like(x) / (torch.exp(-x) + 1.0)
    if activation == "softmax":
        m = x[0]
        for k in range(1, x.shape[0]):
            m = torch.maximum(m, x[k])
        e = torch.exp(x - m[None])
        total = e[0]
        for k in range(1, x.shape[0]):
            total = total + e[k]
        return e / total[None]
    raise KeyError(activation)


def mlp_rows(layers: Layers, activation: str, x: torch.Tensor) -> torch.Tensor:
    """The folded MLP on feature-major ``(in, B)`` rows, each output summed
    over its inputs in order (``acc = acc + w * x``), then its bias."""
    for i, (w, b) in enumerate(layers):
        acc = torch.zeros((w.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
        for k in range(w.shape[1]):
            acc = acc + w[:, k : k + 1] * x[k : k + 1]
        x = acc + b[:, None]
        if i != len(layers) - 1:
            x = activate(activation, x)
    return x


def policy_math(loc_rows, scale_param_rows, eps_rows):
    """The NormalTanh head on rows (``fused_unroll.py:89-110``): returns
    (action rows, pre-tanh rows, log-prob), the log-prob summed over the
    actions in order, term by term."""
    act_rows, raw_rows, logp = [], [], None
    for loc, sp, eps in zip(loc_rows, scale_param_rows, eps_rows):
        scale = softplus(sp) + MIN_STD
        pre = loc + scale * eps
        act_rows.append(torch.tanh(pre))
        raw_rows.append(pre)
        z = (pre - loc) / scale
        normal_lp = -0.5 * (z * z) - torch.log(scale) - HALF_LOG_2PI
        fldj = 2.0 * (LOG2 - pre - softplus(-2.0 * pre))
        term = normal_lp - fldj
        logp = term if logp is None else logp + term
    return act_rows, raw_rows, logp


def unroll_rows(s, es, n_substeps: int, episode_length: int, activation: str, layers: Layers,
                q, v, env, wrap, phase: Optional[torch.Tensor], first, dr, noise, eps):
    """The plain version of K4: T steps of (observation, folded MLP, head,
    ``soa_env.wrapped_step_rows``, gait tick) on ``(rows, B)`` carry blocks
    (``phase`` ``(1, B)``, or None with the clock off) and ``(T, rows, B)``
    noise and eps. Returns (q, v, env, wrap, phase, obs_ts, act_ts, raw_ts,
    logp_ts ``(T, 1, B)``, aux_ts)."""
    nu = s.nu
    obs_r0, obs_n = es.env_rows["obs_history"]
    done_r0 = soa_env.aux_row_map(es)["done"][0]
    ys = []
    for t in range(noise.shape[0]):
        obs = env[obs_r0 : obs_r0 + obs_n]
        if phase is not None:  # the clock before its tick
            obs = torch.cat([obs, torch.cos(phase), torch.sin(phase)])
        h = mlp_rows(layers, activation, obs)
        act, raw, logp = policy_math(h[:nu], h[nu : 2 * nu], eps[t])
        act = torch.stack(act)
        q, v, env, wrap, aux = soa_env.wrapped_step_rows(
            s, es, n_substeps, episode_length, q, v, act, env, noise[t], dr, first, wrap)
        if phase is not None:
            phase = soa_env.tick_gait_clock(phase, es.dphase, aux[done_r0 : done_r0 + 1])
        ys.append((obs, act, torch.stack(raw), logp[None], aux))
    obs_ts, act_ts, raw_ts, logp_ts, aux_ts = (torch.stack(x) for x in zip(*ys))
    return q, v, env, wrap, phase, obs_ts, act_ts, raw_ts, logp_ts, aux_ts


def _check_layers(layers: Layers, obs_dim: int, nu: int, dev) -> List[int]:
    """The layer widths ``[in, h1, ..., 2 nu]``; raises on what K4 does not
    take."""
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"K4 takes 1 to {MAX_LAYERS} layers, got {len(layers)}")
    dims = [obs_dim]
    for i, (w, b) in enumerate(layers):
        for x in (w, b):
            if x.dtype != torch.float32 or x.device != dev or not x.is_contiguous():
                raise ValueError(f"layer {i}: weights must be contiguous float32 on {dev}")
        if w.ndim != 2 or w.shape[1] != dims[-1] or b.shape != (w.shape[0],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)}, bias {tuple(b.shape)} "
                             f"after a width of {dims[-1]}")
        dims.append(w.shape[0])
    if dims[-1] != 2 * nu:
        raise ValueError(f"the policy emits {dims[-1]} logits, expected {2 * nu}")
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"K4 takes layers up to {MAX_WIDTH} wide, got {max(dims)}")
    return dims


def _check_steps(name: str, x: torch.Tensor, T: int, rows: int, B: int, dev):
    if x.dtype != torch.float32 or x.device != dev or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if x.shape != (T, rows, B):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected ({T}, {rows}, {B})")


def _check_inputs(s, es, activation: str, layers: Layers, q, v, env, wrap, phase, first, dr,
                 noise, eps) -> Tuple[int, torch.device, List[int]]:
    """Check one fused unroll's inputs (as ``unroll_rows`` takes them);
    returns (B, device, the layer widths). Raises on what K4 does not take."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"K4 has no activation {activation!r} (one of {ACTIVATIONS})")
    gait = phase is not None
    in_rows, _ = soa_env.block_rows(s, es)
    nq, nv, nu, nenv, nnoise, ndr, nfirst, _ = in_rows
    carry = [q, v, env, wrap] + ([phase] if gait else [])
    B, dev = build.check_blocks([nq, nv, nenv, 2] + [1] * gait + [nfirst, ndr],
                                carry + [first, dr])
    T = noise.shape[0]
    _check_steps("noise", noise, T, nnoise, B, dev)
    _check_steps("eps", eps, T, nu, B, dev)
    return B, dev, _check_layers(layers, es.hist + 2 * gait, nu, dev)


def one_thread_weights(layers: Layers) -> torch.Tensor:
    """The one-thread K4's weight buffer: per layer W (out, in) row-major,
    then b."""
    return torch.cat([torch.cat([w.reshape(-1), b]) for w, b in layers])


def team_weights(layers: Layers) -> torch.Tensor:
    """Team K4's weight buffer: per layer W transposed, (in, out) row-major
    (a chunk's outputs of one input are adjacent), then b."""
    return torch.cat([torch.cat([w.t().reshape(-1), b]) for w, b in layers])


def kernel_call(fn, s, es, activation: str, layers: Layers, weights: torch.Tensor, q, v, env,
                wrap, phase, first, dr, noise, eps, stream: Optional[int] = None):
    """Allocate one fused unroll's outputs and scratch on the inputs'
    device and call ``fn``, a K4 entry point (a launch entry with the
    ``stream``, or a g++ build's host entry without), on checked inputs and
    ``weights`` in that kernel's layout. Returns ``unroll_rows``'s results;
    raises if ``fn`` returns an error."""
    gait = phase is not None
    B, dev, dims = _check_inputs(s, es, activation, layers, q, v, env, wrap, phase, first, dr,
                                noise, eps)
    T = noise.shape[0]
    nq, nv, nu, nenv = s.nq, s.nv, s.nu, es.nenv_rows

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    final = [empty(n, B) for n in (nq, nv, nenv, 2)]
    scratch = [empty(n, B) for n in (nq, nv, nenv, 2)]
    phase_f = empty(1, B) if gait else None
    obs_dim = es.hist + 2 * gait
    steps = [empty(T, n, B) for n in (obs_dim, nu, nu, 1, soa_env.block_rows(s, es)[1][4])]
    tensors = [q, v, env, wrap, phase, first, dr, noise, eps, weights, *final, phase_f, *steps,
               *scratch]
    padded = dims + [0] * (MAX_LAYERS + 1 - len(dims))
    ints = [B, T, len(layers), ACTIVATIONS.index(activation), int(gait), *padded]
    rc = fn(*[None if x is None else x.data_ptr() for x in tensors], *ints,
            *([] if stream is None else [stream]))
    if rc != 0:
        raise RuntimeError(f"fused unroll kernel failed: error {rc}")
    return (*final, phase_f, *steps)


def _route(wrapper, kernel: build.Kernel, library, weights_of, s, es, n_substeps: int,
           episode_length: int, activation: str, layers: Layers, *blocks):
    """CPU blocks through ``unroll_rows``; CUDA blocks through one launch of
    ``kernel`` from ``library`` on the current stream (a box model's team
    body with its global scratch, ``build.bind_scratch``), counted on
    ``wrapper``."""
    dev = blocks[0].device
    if dev.type == "cpu":
        _check_inputs(s, es, activation, layers, *blocks)
        return unroll_rows(s, es, n_substeps, episode_length, activation, layers, *blocks)
    if dev.type != "cuda":
        raise ValueError(f"fused unroll: unsupported device {dev}")
    lib = library(s, es, n_substeps, episode_length)
    build.bind_scratch(lib, kernel, blocks[0].shape[-1], dev)
    out = kernel_call(getattr(lib, kernel.launch), s, es, activation, layers, weights_of(layers),
                      *blocks, stream=torch.cuda.current_stream(dev).cuda_stream)
    wrapper.launches += 1
    return out


def unroll(s, es, n_substeps: int, episode_length: int, activation: str, layers: Layers,
           q, v, env, wrap, phase: Optional[torch.Tensor], first, dr, noise, eps):
    """T fused policy + env steps over ``(rows, B)`` carry blocks and
    ``(T, rows, B)`` noise and eps (arguments and results as
    ``unroll_rows``).

    CPU tensors run the plain version (``unroll_rows``); CUDA tensors launch
    team K4 (``csrc/fused_unroll_team.cuh``) on the current stream, or
    raise. Each launch adds one to ``unroll.launches``."""
    return _route(unroll, build.FUSED_UNROLL_TEAM, build.fused_unroll_team_library,
                  team_weights, s, es, n_substeps, episode_length, activation, layers,
                  q, v, env, wrap, phase, first, dr, noise, eps)


unroll.launches = 0


def unroll_one_thread(s, es, n_substeps: int, episode_length: int, activation: str,
                      layers: Layers, q, v, env, wrap, phase: Optional[torch.Tensor], first, dr,
                      noise, eps):
    """``unroll`` through the one-thread K4 (``csrc/fused_unroll.cuh``, one
    env per thread): the A/B baseline of team K4, off the main path. CPU
    tensors run ``unroll_rows``; CUDA tensors launch it or raise. Each
    launch adds one to ``unroll_one_thread.launches``."""
    return _route(unroll_one_thread, build.FUSED_UNROLL, build.fused_unroll_library,
                  one_thread_weights, s, es, n_substeps, episode_length, activation, layers,
                  q, v, env, wrap, phase, first, dr, noise, eps)


unroll_one_thread.launches = 0


def policy_op_count(dims: Sequence[int], activation: str, nu: int, gait: bool) -> int:
    """Float operations of one env's policy step in K4, counted from the
    kernel's source: per output of a layer 2 per input (multiply, add) and
    1 for the bias; per hidden unit its activation (elu 2, relu 1, tanh 1,
    sigmoid 3, softmax 4); per action the head's 23 (softplus 3, the
    sample 3, tanh 1, the log density 7, the Jacobian term 7, the sum 2);
    the clock's 5 (cos, sin, add, fmod, compare)."""
    per_unit = {"elu": 2, "relu": 1, "tanh": 1, "sigmoid": 3, "softmax": 4}[activation]
    mlp = sum(n_out * (2 * n_in + 1) for n_in, n_out in zip(dims[:-1], dims[1:]))
    hidden = sum(dims[1:-1])
    return mlp + per_unit * hidden + 23 * nu + (5 if gait else 0)
