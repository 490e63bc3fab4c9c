"""Stateless per-element hash RNG for analog-update noise.

A murmur3-style integer hash of (linear index, seed, salt), bit-identical
to the JAX package's ``kernels/fastrng.py``: the same uint32 bits, and
normals through the same inverse CDF (bitcast fast log + Giles' erfinv
polynomials). uint32 math runs in int64 with ``& 0xFFFFFFFF`` masks.

``seed`` is a ``(2,)`` int64 tensor of uint32 words, or a ``(n, 2)`` batch
of them: a batch draws ``(n, *shape)``, row i being exactly the draw for
seed i alone (the linear index restarts per row).

``hash_normal`` agrees with JAX to a few ULP, not bit for bit: XLA-CPU's
``sqrt`` on the tail branch differs from torch's by one ULP on some inputs.
"""
from __future__ import annotations

import math

import torch

from ..prng import MASK, mul32

_SQRT2 = 1.4142135623730951
# f32 just below 1: keeps erfinv off its +/-1 poles (see the JAX module)
_ONE_MINUS_EPS = 0.99999994
_LN2 = 0.6931471805599453
_ERFINV_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164,
                   0.246640727, 1.50140941)
_ERFINV_TAIL = (0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047,
                1.00167406, 2.83297682)


def _finalize(x):
    """murmur3 fmix32 finalizer on int64-held uint32."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _seed_words(seed, ndim: int, device):
    """Seed words as ints, or as ``(n, 1, ..., 1)`` tensors for a batch."""
    seed = torch.as_tensor(seed).to(torch.int64)
    if seed.ndim == 1:
        return int(seed[0]), int(seed[1])
    s = seed.to(device).reshape(seed.shape[0], 2, *([1] * ndim))
    return s[:, 0], s[:, 1]


def hash_bits(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """uint32 hash bits of ``shape`` (int64 in [0, 2**32))."""
    shape = tuple(int(d) for d in shape)
    s0, s1 = _seed_words(seed, len(shape), device)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape) & MASK
    x = (mul32(idx, 0xCC9E2D51) + s0 + ((salt * 0x9E3779B9) & MASK)) & MASK
    x = _finalize(x)
    x = x ^ ((s1 + (salt & MASK)) & MASK)
    return _finalize(x)


def hash_uniform(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """[0, 1) float32."""
    return hash_bits(seed, shape, salt, device).to(torch.float32) * (
        1.0 / 4294967296.0)


def _fast_neg_log(y: torch.Tensor) -> torch.Tensor:
    """-log(y) for float32 y in (0, 1] by an exponent/mantissa bitcast split.
    The last term divides tensor by tensor: ``float / tensor`` in torch is a
    multiply by the reciprocal, which rounds differently."""
    bi = y.view(torch.int32)
    mant = ((bi & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    num = torch.full_like(mant, 1.72587999)
    log2y = (bi.to(torch.float32) * 1.1920928955078125e-07
             - 124.22551499 - 1.498030302 * mant
             - num / (0.3520887068 + mant))
    return -_LN2 * log2y


def hash_normal(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """Standard normal by the inverse CDF of one hashed uniform."""
    u = (hash_bits(seed, shape, salt, device).to(torch.float32) + 0.5) * (
        1.0 / 4294967296.0)
    x = torch.clamp(2.0 * u - 1.0, -_ONE_MINUS_EPS, _ONE_MINUS_EPS)
    w = _fast_neg_log(1.0 - x * x)
    wc = w - 2.5
    p1 = torch.full_like(w, 2.81022636e-08)
    for c in _ERFINV_CENTRAL:
        p1 = p1 * wc + c
    ws = torch.sqrt(torch.clamp_min(w, 5.0)) - 3.0
    p2 = torch.full_like(w, -0.000200214257)
    for c in _ERFINV_TAIL:
        p2 = p2 * ws + c
    return _SQRT2 * torch.where(w < 5.0, p1, p2) * x


def seed_from_key(key) -> torch.Tensor:
    """PRNG key -> uint32 seed words (the raw key data); a ``(n, 2)`` batch
    of keys gives a batch of seeds."""
    return torch.as_tensor(key).to(torch.int64)[..., :2]
