"""jax's threefry2x32 PRNG in torch: the same keys and the same draws.

The port draws every random number as the JAX package does, from
``jax.random`` keys under jax's defaults (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``), so a run of the
port replays a run of the reference from its seed. jax's own source is the
specification (``jax/_src/prng.py``, ``jax/_src/random.py``); this module
keeps its own copy of every constant.

A key is a ``(..., 2)`` ``torch.int32`` tensor holding the two uint32 words
of ``jax.random.key_data`` (``key.numpy().view(np.uint32)`` is jax's key).
Every function takes keys with leading batch dims and draws for each key
as ``jax.vmap`` over the keys would: ``(B, 2)`` keys and a draw of shape
``s`` give ``(B, *s)``.

The hash: ``threefry2x32`` is the plain version (int64 arithmetic masked
to 32 bits, 20 rounds and 5 key injections). ``threefry`` runs it for
every (key, counter) pair of a draw, with the draw's transform: the pair
(``split``, ``fold_in``), its xor (``random_bits``), a uniform
(``uniform``'s mantissa trick and multiply-add) or a normal (``normal``'s
erf_inv). On CUDA tensors it launches the hand-written kernel
``csrc/threefry.cuh`` (``build.threefry_library``, one thread per pair,
the transform in registers) and adds one to ``threefry.launches``; on CPU
tensors it runs ``threefry_rows``, the plain version. What follows a draw
(``choice``'s inverse CDF, ``permutation``'s sorts) is torch ops.

XLA's CPU backend contracts ``a * b + c`` into one multiply-add where the
reference draws (``uniform``'s scale and shift, erf_inv's Horner steps),
so the plain version rounds those once (``fma``) and the kernel calls
``fmaf``.

``normal`` uses XLA's float32 erf_inv (Giles' polynomial, the form of
XLA's ``ErfInv32``), not ``torch.erfinv``: it agrees with jax within a few
ulp (the two libraries' ``log1p``), where ``torch.erfinv`` parts by tens.
Every other draw is bit for bit jax's.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): Horner
# coefficients, highest degree first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
# nextafter(-1, 0) in float32: normal's lower uniform bound
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

Key = torch.Tensor
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(n) for n in shape)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the uint32 value."""
    return x.to(torch.int64) & _MASK


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (``prng.py:_threefry2x32_lowering``, its rounds
    ``apply_round``) on int64 tensors holding uint32 values, broadcast
    together; returns the two output words as such tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


# the kernel's output modes (csrc/threefry.cuh): the two words of each pair
# (split, fold_in), their xor (random_bits), a uniform float32 between the
# bounds, a standard normal
PAIRS, BITS, UNIFORM, NORMAL = 0, 1, 2, 3


def _floats01(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): 23 mantissa bits under exponent
    0, minus 1 (a logical shift by 9: the arithmetic shift's low 23 bits are
    the same)."""
    return ((bits >> 9) & 0x7FFFFF | 0x3F800000).view(torch.float32) - 1.0


def threefry_rows(keys: torch.Tensor, n: int, mode: int, offset: int = 0,
                  lo: torch.Tensor = None, hi: torch.Tensor = None) -> torch.Tensor:
    """The plain version of the kernel: for every key of ``keys`` ``(R, 2)``
    and counter ``(hi, lo) = (0, offset + i)``, ``i < n`` (the partitionable
    layout's ``iota_2x32_shape`` of a draw of ``n``), the hash's output in
    ``mode``: ``PAIRS`` ``(R, n, 2)`` int32, ``BITS`` ``(R, n)`` int32,
    ``UNIFORM`` ``(R, n)`` float32 between the ``(n,)`` bounds ``lo`` and
    ``hi``, ``NORMAL`` ``(R, n)`` float32."""
    k = _u32(keys)
    ctr = torch.arange(offset, offset + n, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(ctr), ctr)
    if mode == PAIRS:
        return torch.stack([_i32(y1), _i32(y2)], -1)
    bits = _i32(y1 ^ y2)
    if mode == BITS:
        return bits
    if mode == NORMAL:
        lo = torch.full((n,), _NORMAL_LO, device=keys.device)
        hi = torch.ones(n, device=keys.device)
    u = torch.maximum(lo, fma(_floats01(bits), hi - lo, lo))
    return u if mode == UNIFORM else _SQRT2_F32 * erf_inv(u)


def threefry(keys: torch.Tensor, n: int, mode: int, offset: int = 0,
             lo: torch.Tensor = None, hi: torch.Tensor = None) -> torch.Tensor:
    """``threefry_rows`` on CPU tensors; on CUDA tensors one launch of the
    kernel (``csrc/threefry.cuh``: one thread per (key, counter) pair) or a
    raise. Each launch adds one to ``threefry.launches``."""
    if keys.dtype != torch.int32 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (R, 2) int32, got {tuple(keys.shape)} {keys.dtype}")
    if offset < 0 or offset + n > 2**32:
        raise ValueError(f"counters {offset} .. {offset + n} exceed 32 bits")
    if mode == UNIFORM and (lo is None or hi is None or lo.shape != (n,) or hi.shape != (n,)):
        raise ValueError(f"a uniform draw of {n} takes ({n},) bounds")
    if keys.stride(1) != 1:  # a key's two words side by side; rows may lie apart
        keys = keys.contiguous()
    # the frozen copy runs the plain version on every device
    return threefry_rows(keys, int(n), mode, int(offset), lo, hi)


threefry.launches = 0
_LIB: list = []  # the loaded kernel library, once built


def _rows(keys: Key) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    if keys.shape[-1] != 2:
        raise ValueError(f"a key's last dim is 2, got shape {tuple(keys.shape)}")
    return keys.reshape(-1, 2), tuple(keys.shape[:-1])


# ---- keys -----------------------------------------------------------------


def key(seed: int, device="cpu") -> Key:
    """``jax.random.PRNGKey(seed)`` (``prng.py:threefry_seed``): the seed's
    high and low 32 bits. Without x64, jax takes the seed as an int32, so a
    negative seed keeps its low word."""
    seed = int(seed)
    if seed < 0:
        if seed < -(2**31):
            raise OverflowError(f"seed {seed} is outside int32")
        seed &= _MASK
    elif seed >= 2**63:
        raise OverflowError(f"seed {seed} is outside int64")
    words = torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64)
    return _i32(words).to(device)


def split(keys: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)`` per key: ``(..., 2)`` -> ``(..., num,
    2)`` (``_threefry_split_foldlike``)."""
    rows, batch = _rows(keys)
    return threefry(rows, int(num), PAIRS).reshape(batch + (int(num), 2))


def fold_in(keys: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` per key: the hash of the counter
    ``(0, data)`` (``threefry_seed(uint32(data))``)."""
    rows, batch = _rows(keys)
    return threefry(rows, 1, PAIRS, offset=int(data) & _MASK).reshape(batch + (2,))


def random_bits(keys: Key, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) per key, as int32 with the
    same bits: ``(..., *shape)``."""
    shape = _shape(shape)
    rows, batch = _rows(keys)
    return threefry(rows, math.prod(shape), BITS).reshape(batch + shape)


# ---- draws -----------------------------------------------------------------


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors rounded once, as XLA's CPU backend
    contracts it: the float32 product is exact in float64, the float64 sum
    is corrected where it lands on a float32 midpoint (TwoSum's error
    breaks the tie)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    half = s - r64  # where s is a float32 midpoint: half its spacing
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(half > 0, inf, -inf))  # the neighbour toward s
    mid = (half != 0) & (2 * torch.abs(half) == torch.abs(nb.to(torch.float64) - r64))
    away = mid & (err != 0) & (torch.sign(err) == torch.sign(half))
    return torch.where(away, nb, r)


_CONSTANTS = {}


def _cached(arr: np.ndarray, device) -> torch.Tensor:
    """A float32 array as a tensor on ``device``, copied there once per
    value and device (a draw's constants, so no draw waits on a copy)."""
    k = (arr.tobytes(), arr.shape, device)
    if k not in _CONSTANTS:
        _CONSTANTS[k] = torch.from_numpy(arr.copy()).to(device)
    return _CONSTANTS[k]


def _bound_row(x, shape: Tuple[int, ...], device) -> torch.Tensor:
    """A uniform bound broadcast over the draw's shape (``lax.
    broadcast_to_rank``), flat: a float32 ``(prod(shape),)`` tensor."""
    if isinstance(x, (float, int)):  # the common case, without numpy
        k = (float(x), shape, device)
        if k not in _CONSTANTS:
            _CONSTANTS[k] = _cached(np.full(math.prod(shape), x, np.float32), device)
        return _CONSTANTS[k]
    return _cached(np.broadcast_to(np.asarray(x, np.float32), shape).ravel(), device)


def uniform(keys: Key, shape: Shape = (), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per key
    (``random.py:_uniform``): 23 random mantissa bits under exponent 0,
    minus 1, scaled and shifted in one multiply-add (XLA contracts it) and
    floored at ``minval``. ``minval`` and ``maxval`` (floats or arrays)
    broadcast against ``shape``, as jax's do."""
    shape = _shape(shape)
    rows, batch = _rows(keys)
    n = math.prod(shape)
    lo, hi = (_bound_row(x, shape, keys.device) for x in (minval, maxval))
    return threefry(rows, n, UNIFORM, lo=lo, hi=hi).reshape(batch + shape)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (``ErfInv32``): Giles' polynomial in
    ``w = -log1p(-x * x)``, in ``w - 2.5`` below 5 and ``sqrt(w) - 3``
    above, each Horner step one multiply-add; +-inf at +-1."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype, device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype, device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, coef(i))  # XLA contracts the Horner steps
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(keys: Key, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` per key
    (``random.py:_normal_real``): ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform in ``[nextafter(-1, 0), 1)``."""
    shape = _shape(shape)
    rows, batch = _rows(keys)
    return threefry(rows, math.prod(shape), NORMAL).reshape(batch + shape)


def bernoulli(keys: Key, p: float, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` per key: ``uniform < p``."""
    return uniform(keys, shape) < float(np.float32(p))


def choice_p(keys: Key, p) -> torch.Tensor:
    """The index ``jax.random.choice(key, len(p), p=p)`` draws per key
    (``random.py:choice`` with replacement): the inverse CDF
    ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))`` on one uniform.
    The cumsum is float32 and in order, as XLA's window sum on the CPU."""
    cdf = np.cumsum(np.asarray(p, np.float32), dtype=np.float32)
    cdf_t = _cached(cdf, keys.device)
    r = cdf_t[-1] * (1.0 - uniform(keys, ()))
    return torch.searchsorted(cdf_t, r.contiguous())


def permutation(keys: Key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key (``random.py:_shuffle``):
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a split and a stable sort
    on fresh 32-bit keys. Returns an int64 ``(n,)`` tensor."""
    if keys.shape != (2,):
        raise ValueError(f"permutation takes one (2,) key, got {tuple(keys.shape)}")
    x = torch.arange(int(n), device=keys.device)
    rounds = int(np.ceil(3 * np.log(max(1, int(n))) / np.log(np.iinfo(np.uint32).max)))
    k = keys
    for _ in range(rounds):
        k, sub = split(k)
        sort_keys = _u32(random_bits(sub, (int(n),)))
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


def from_key_data(data, device="cpu") -> Key:
    """uint32 key data (jax's ``key_data``, numpy) -> keys on ``device``."""
    arr = np.ascontiguousarray(np.asarray(data, np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)
