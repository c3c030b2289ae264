"""Counter-based threefry-2x32 PRNG, bit for bit the stream of ``jax.random``.

The counterpart of ``jax.random`` as the installed jax 0.9.0 defines it
with ``jax_default_prng_impl = threefry2x32`` and
``jax_threefry_partitionable = True``: the same key gives the same
``split``, ``fold_in``, ``random_bits``, ``uniform``, ``randint`` and
``bernoulli`` bits, and ``normal`` within a few ulp (it needs ``log1p``,
whose last bit differs between XLA and torch).  So a seeded Monte Carlo
draw or search in ``repro_torch.dse`` makes the same choices as the JAX
package's.

A key is an int64 tensor whose last axis holds the two 32-bit words
``(k1, k2)`` of a JAX ``uint32[2]`` key.  Every function takes a *batch*
of keys, shape ``(..., 2)``, and prepends the batch axes to its result:
``normal(split(key, n), ())`` is JAX's ``vmap(lambda k: normal(k, ()))
(split(key, n))`` in one call.  The 32-bit words ride in int64 masked to
32 bits, because ``torch.uint32`` has no add, shift or remainder.
Results land on the key's device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from . import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``: 20 rounds, five key injections, on int64
    tensors holding 32-bit words (all four broadcast together)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    # a is carried unmasked (its bits past 32 never reach the low 32 of a
    # sum, and b is masked after each xor); int64 holds 20 rounds of it
    a = x1 + ks[0]
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = (((b << r) | (b >> (32 - r))) ^ a) & _MASK
        a = a + ks[(i + 1) % 3]
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a & _MASK, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed &
    0xFFFFFFFF)`` of a 32-bit seed, i.e. ``(0, seed)``; on ``device``
    (the GPU unless the caller names another)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def as_key(key, device=None) -> torch.Tensor:
    """A key (or batch of keys) given as a tensor, a numpy or JAX
    ``uint32`` array or a list, as the int64 tensor the functions here
    take; on ``device``, or where a tensor already is."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64) & _MASK
        return k if device is None else k.to(device)
    arr = np.asarray(key).astype(np.uint64).astype(np.int64)
    return torch.as_tensor(arr, device=resolve_device(device))


def key_data(key: torch.Tensor) -> np.ndarray:
    """The key as the host ``uint32`` array JAX keeps (a copy to the
    host)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def _words(key: torch.Tensor, ndim: int):
    """The key words of a batch of keys, shaped to broadcast against
    ``ndim`` trailing sample axes."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has a last axis of 2 words, got shape "
                         f"{tuple(key.shape)}")
    lead = tuple(key.shape[:-1]) + (1,) * ndim
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def _counters(shape: Tuple[int, ...], device):
    """The partitionable counter layout: each element's 64-bit linear
    index as (hi, lo) words (``prng.iota_2x32_shape``)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., *num, 2)`` new keys, key ``i`` being
    the hash of the counter ``(0, i)``."""
    shape = _shape(num)
    k1, k2 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``, data
    taken as uint32."""
    k1, k2 = key[..., 0], key[..., 1]
    d = torch.full((), int(data) & _MASK, dtype=torch.int64,
                   device=key.device)
    a, b = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: ``(..., *shape)`` words in int64,
    the xor of the two hash words of each element's counter."""
    shape = _shape(shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return a ^ b


def _f32(x: float, device) -> torch.Tensor:
    """x rounded to float32, filled on the device (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), less 1, scaled, clamped below at ``minval``."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p``."""
    return uniform(key, shape) < _f32(p, key.device)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` in int32: two words a draw, from the two
    halves of ``split(key)``, folded into the span with the reference's
    remainder arithmetic (biased exactly as it is)."""
    lo, hi = int(minval), int(maxval)
    if not -2 ** 31 <= min(lo, hi) <= max(lo, hi) < 2 ** 31:
        raise OverflowError(f"randint bounds {lo}, {hi} do not fit int32")
    span = 1 if hi <= lo else hi - lo
    # 2**32 % span as the reference takes it: the square wraps in uint32
    multiplier = ((((2 ** 16) % span) ** 2) & _MASK) % span
    # both halves of the split key in one batched pass
    higher, lower = random_bits(split(key), shape).unbind(key.ndim - 1)
    offset = ((higher % span) * multiplier + lower % span) & _MASK
    return (lo + offset % span).to(torch.int32)


# Giles' single-precision erfinv, the polynomial XLA lowers lax.erf_inv to
# in float32: branch w < 5 and w >= 5, nine coefficients each.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, as XLA computes ``lax.erf_inv``
    (not ``torch.erfinv``, which rounds differently by tens of ulp)."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _f32(_ERFINV_SMALL[0], x.device),
                    _f32(_ERFINV_LARGE[0], x.device))
    w64 = w.double()
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, _f32(cs, x.device), _f32(cl, x.device))
        # XLA contracts each Horner step into a fused multiply-add: the
        # float32 product is exact in float64, so one rounding of the f64
        # sum to float32 gives the fused result
        p = (c.double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``, ``u``
    uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _f32(float(np.sqrt(np.float32(2.0))), key.device) * erf_inv(u)
