"""Frozen copies of the random chains the benchmark's configurations fix.

A training step of the port draws three kinds of randomness, each
deterministic given the run's key:
  * the key chain: threefry-2x32 (``jax.random``'s, partitionable form),
    ``split`` and ``fold_in``, a CRC of a tile's path folded in, and the
    chopper's Bernoulli draw (a float32 uniform below ``p``);
  * the device draw (paper App. F.1): per-element ``gamma = exp(sigma_d2d
    n11)`` and ``rho`` from a second normal (salt 13, or salt 17 for a
    target symmetric point), the normals by the murmur3-style hash of
    (linear index, seed, salt) and its inverse CDF;
  * the pulse update's noise: hash bits of salt 1 for the stochastic
    rounding, hash normals of salt 2 for the cycle-to-cycle term.

The expressions are written out operation by operation in float32, as the
configuration's ``rng: hash`` fixes them, so a draw here is the same
float32 value on every device. uint32 arithmetic runs in int64 under
``& 0xFFFFFFFF`` masks. Draws are made over a range of linear indices, so
a large tile can be drawn in pieces.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_MINUS_EPS = 0.99999994
_LN2 = 0.6931471805599453
_SQRT2 = 1.4142135623730951
_ERFINV_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164,
                   0.246640727, 1.50140941)
_ERFINV_TAIL = (0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047,
                1.00167406, 2.83297682)
F32 = torch.float32


def mul32(x, c: int):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), in 16-bit halves."""
    c &= MASK
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK
    return x0, x1


def key_of_seed(seed: int) -> torch.Tensor:
    """The run's key: a seed of 32 signed bits pads to (0, seed); a larger
    one splits into its high and low words."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if not -2 ** 31 <= seed < 2 ** 31 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(2,) key -> (num, 2) keys: subkey i is threefry(key, (0, i))."""
    k0, k1 = int(key[0]), int(key[1])
    cnt = torch.arange(num, dtype=torch.int64)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k0, k1 = int(key[0]), int(key[1])
    d = torch.tensor([int(data) & MASK], dtype=torch.int64)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([b0[0], b1[0]])


def crc_fold(key: torch.Tensor, name: str) -> torch.Tensor:
    """``key`` with the CRC-32 of ``name`` folded in (a path-keyed stream)."""
    return fold_in(key, zlib.crc32(name.encode()))


def bernoulli(key: torch.Tensor, p: float) -> bool:
    """One float32 uniform of ``key`` (23 mantissa bits under 1.0's
    exponent, less 1) below float32 ``p``."""
    k0, k1 = int(key[0]), int(key[1])
    zero = torch.zeros(1, dtype=torch.int64)
    b0, b1 = threefry2x32(k0, k1, zero, zero)
    fb = ((b0 ^ b1) >> 9) | 0x3F800000
    u = torch.clamp_min(fb.to(torch.int32).view(F32) - 1.0, 0.0)
    return bool(u[0] < torch.tensor(p, dtype=F32))


def _finalize(x):
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_bits(seed: torch.Tensor, start: int, count: int, salt: int,
              device) -> torch.Tensor:
    """uint32 hash bits (int64) of linear indices [start, start + count)."""
    s0, s1 = int(seed[0]) & MASK, int(seed[1]) & MASK
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device) & MASK
    x = (mul32(idx, 0xCC9E2D51) + s0 + ((salt * 0x9E3779B9) & MASK)) & MASK
    x = _finalize(x)
    x = x ^ ((s1 + (salt & MASK)) & MASK)
    return _finalize(x)


def _fast_neg_log(y: torch.Tensor) -> torch.Tensor:
    bi = y.view(torch.int32)
    mant = ((bi & 0x007FFFFF) | 0x3F000000).view(F32)
    num = torch.full_like(mant, 1.72587999)
    log2y = (bi.to(F32) * 1.1920928955078125e-07
             - 124.22551499 - 1.498030302 * mant
             - num / (0.3520887068 + mant))
    return -_LN2 * log2y


def hash_normal(seed: torch.Tensor, start: int, count: int, salt: int,
                device) -> torch.Tensor:
    """float32 standard normals of linear indices [start, start + count):
    the inverse CDF (Giles' erfinv polynomials) of one hashed uniform."""
    u = (hash_bits(seed, start, count, salt, device).to(F32) + 0.5) * (
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


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division in ``x``'s dtype."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def device_params(seed: torch.Tensor, start: int, count: int, device,
                  dev: Dict) -> tuple:
    """float32 ``(gamma, rho)`` of linear indices [start, start + count) of
    a tile whose device seed is ``seed``, for the device ``dev`` (a
    configuration's device dict)."""
    tau_min, tau_max = float(dev["tau_min"]), float(dev["tau_max"])
    sigma_d2d = float(dev["sigma_d2d"])
    if sigma_d2d > 0:
        gamma = torch.exp(sigma_d2d * hash_normal(seed, start, count, 11,
                                                  device))
    else:
        gamma = torch.ones(count, dtype=F32, device=device)
    ref_mean, ref_std = float(dev["ref_mean"]), float(dev["ref_std"])
    if ref_mean != 0.0 or ref_std != 0.0:
        # rho giving a target symmetric point w* ~ N(ref_mean, ref_std^2)
        w_star = ref_mean + ref_std * hash_normal(seed, start, count, 17,
                                                  device)
        w_star = torch.clamp(w_star, -0.95 * tau_min, 0.95 * tau_max)
        num = w_star * gamma * (tau_min + tau_max)
        den = 2.0 * tau_min * tau_max + w_star * (tau_min - tau_max)
        rho = num / den
    else:
        rho = float(dev["sigma_pm"]) * hash_normal(seed, start, count, 13,
                                                   device)
    # |rho| < gamma keeps both slopes positive (Def. 2.1)
    return gamma, torch.minimum(torch.maximum(rho, -0.95 * gamma),
                                0.95 * gamma)


def pieces(n: int, size: int = 1 << 24):
    """(start, count) over [0, n) in pieces of at most ``size``."""
    for start in range(0, n, size):
        yield start, min(size, n - start)


def numel(shape) -> int:
    return int(math.prod(shape))
