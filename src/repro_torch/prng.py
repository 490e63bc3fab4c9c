"""Threefry-2x32 keys and draws, bit-compatible with ``jax.random``.

The JAX package keys every random draw with threefry2x32 under
``jax_threefry_partitionable=True``. This module reproduces that chain so
the port consumes the same bits from the same seeds:

* a key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
  (``key_data`` / ``wrap_key_data`` are identities). Keys stay on the host:
  the key chain is a handful of tiny hashes per step and never needs the
  card, so it costs no device launch and no host-device sync;
* draws at a weight's shape (``bits``, ``uniform``, ``normal``,
  ``truncated_normal``) run on ``device``.

torch has no uint32 arithmetic on every backend, so all uint32 math runs in
int64 with ``& 0xFFFFFFFF`` masks; products are split in 16-bit halves so no
int64 product overflows.

``normal`` goes through ``erf_inv`` below, a port of the f32 polynomial XLA
uses for ``lax.erf_inv`` (Giles 2012), not ``torch.erfinv``. XLA-CPU's
``log1p`` and ``sqrt`` differ from torch's by up to 2 ULP on some inputs, so
normals agree with JAX to a few ULP; bits and uniforms are bit-exact.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))

# Giles (2012) single-precision erfinv coefficients, as XLA's f32 erf_inv.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def mul32(x, c: int):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a constant ``c``,
    without an int64 product overflow."""
    c &= MASK
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds. Key words are ints or int64 tensors that
    broadcast against the int64 counter words ``x0``/``x1``."""
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


# ---------------------------------------------------------------------------
# keys (host)
# ---------------------------------------------------------------------------


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey``: a 32-bit seed pads to (0, seed); a 64-bit
    seed splits into its high and low words."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if not -2 ** 31 <= seed < 2 ** 31 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64)


def key_data(key: torch.Tensor) -> torch.Tensor:
    return key


def wrap_key_data(data) -> torch.Tensor:
    if torch.is_tensor(data):
        return data.to(torch.int64) & MASK
    return torch.tensor(np.asarray(data).astype(np.int64)) & MASK


def _words(key: torch.Tensor):
    key = key.to(torch.int64)
    return key[..., 0], key[..., 1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): subkey i is
    threefry(key, (0, i)). A batch of keys ``(..., 2)`` splits to
    ``(..., num, 2)``."""
    k0, k1 = _words(key)
    k0, k1 = k0[..., None], k1[..., None]
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry(key, (0, data))."""
    k0, k1 = _words(key)
    d = torch.full_like(k0, int(data) & MASK)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


# ---------------------------------------------------------------------------
# draws (any device)
# ---------------------------------------------------------------------------


def bits(key: torch.Tensor, shape: Sequence[int], device="cuda") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2**32)."""
    shape = tuple(int(d) for d in shape)
    k0, k1 = (int(v) for v in key.to(torch.int64).reshape(2).tolist())
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(shape)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once, as XLA-CPU contracts it inside a
    fusion. The float64 product of two float32 values is exact, and for the
    O(1) operands used here so is the float64 sum, so the one rounding to
    float32 is the fused result."""
    a64 = a.to(torch.float64)
    b = b.to(torch.float64) if torch.is_tensor(b) else b
    c = c.to(torch.float64) if torch.is_tensor(c) else c
    return (a64 * b + c).to(torch.float32)


def _f32(v: float) -> float:
    return float(np.float32(v))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cuda") -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, shifted and scaled to [minval, maxval)."""
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    fb = (bits(key, shape, device) >> 9) | 0x3F800000
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(fma(floats, span, lo), lo)


def bernoulli(key, p: float, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli``: uniform < p in float32."""
    return uniform(key, shape, device=device) < _f32(p)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' polynomials in w = -log1p(-x^2)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erf_inv(u),
    u ~ U[nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _SQRT2_F32 * erf_inv(u)


def truncated_normal(key, lower: float, upper: float, shape,
                     device="cuda") -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32 (inverse CDF between
    erf(lower/sqrt2) and erf(upper/sqrt2), clipped just inside the bounds)."""
    s2 = np.float32(_SQRT2_F32)
    lo32, hi32 = np.float32(lower), np.float32(upper)
    a = _f32(math.erf(float(lo32 / s2)))
    b = _f32(math.erf(float(hi32 / s2)))
    out = _SQRT2_F32 * erf_inv(uniform(key, shape, a, b, device))
    return torch.clamp(out, float(np.nextafter(lo32, np.float32(np.inf))),
                       float(np.nextafter(hi32, np.float32(-np.inf))))
