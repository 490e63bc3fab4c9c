"""The exact rewrites of K1 and the hash normal (``csrc/fastrng.cuh``,
``csrc/analog_update.cu``) held on the CPU against the eager float32 chain
they stand for, each operation emulated with one rounding to float32.

The card's own checks are exhaustive (``chip_smoke.py`` phase 3: the
configs' divisors and random ones over all 2^32 x, the normal's division
over all 2^23 mantissas, the square-root table); these run in a few
seconds on samples:

* the three folds of a product by a power of two into one fma, over all
  b < 2^16, the edges near 2^24 and 2^32 - 1 and a strided sample;
* the division by a launch scalar (``div_fast`` where ``div_ok``) for the
  configs' divisors and divisors drawn at random over its range, on
  edges, subnormals and random bit patterns, each operation computed in
  ``fractions.Fraction`` and rounded once;
* the wrapper's host-side scalars (``analog_update.launch_scalars``) and
  the square-root table's index.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

from repro_torch.kernels import analog_update

F32 = np.float32


def fma32(a, b, c):
    """float32 fma: a * b + c exactly, rounded once to float32 (arrays).
    a * b is exact in float64; the sum's rounding error comes from TwoSum,
    and a float64 sum that lands on a float32 midpoint moves to the side
    of the exact value."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64) + np.zeros_like(p)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    f = s.astype(F32)
    up = np.nextafter(f, F32(np.inf)).astype(np.float64)
    dn = np.nextafter(f, F32(-np.inf)).astype(np.float64)
    f64 = f.astype(np.float64)
    out = f.copy()
    at_up = (s == (f64 + up) / 2) & (t != 0)
    at_dn = (s == (f64 + dn) / 2) & (t != 0)
    out[at_up & (t > 0)] = up[at_up & (t > 0)].astype(F32)
    out[at_dn & (t < 0)] = dn[at_dn & (t < 0)].astype(F32)
    return out


def uint_samples():
    """uint32 inputs: all below 2^16, the edges near 2^24 and 2^32 - 1 and
    a strided sample of the rest."""
    return np.unique(np.concatenate([
        np.arange(1 << 16, dtype=np.uint64),
        np.arange((1 << 24) - 4096, (1 << 24) + 4096, dtype=np.uint64),
        np.arange((1 << 32) - 8192, 1 << 32, dtype=np.uint64),
        np.arange(0, 1 << 32, 65521, dtype=np.uint64)])).astype(np.uint32)


def bits_equal(a, b):
    return np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_fold_uniform_of_bits():
    """(b + 0.5) * 2^-32 == fma(b, 2^-32, 2^-33), b = float(bits)."""
    b = uint_samples().astype(F32)          # round to nearest, as I2F
    eager = (b + F32(0.5)) * F32(2.0 ** -32)
    assert bits_equal(fma32(b, F32(2.0 ** -32), F32(2.0 ** -33)), eager)


def test_fold_two_u_minus_one():
    """2u - 1 == fma(u, 2, -1) for every u the uniform takes here."""
    b = uint_samples().astype(F32)
    u = (b + F32(0.5)) * F32(2.0 ** -32)
    u = np.concatenate([u, np.linspace(0, 1, 4097, dtype=F32)])
    eager = F32(2.0) * u - F32(1.0)
    assert bits_equal(fma32(u, F32(2.0), F32(-1.0)), eager)


def test_fold_log_bits():
    """float(bi) * 2^-23 - 124.22551499 == one fma, bi the bits of y in
    (0, 1]."""
    bi = uint_samples()
    bi = np.concatenate([bi[(bi >= 1) & (bi <= 0x3F800000)],
                         np.arange(0x3F800000 - 4096, 0x3F800001,
                                   dtype=np.uint32)])
    bf = bi.astype(np.int32).astype(F32)
    c = F32(124.22551499)
    eager = bf * F32(1.1920928955078125e-07) - c
    assert bits_equal(fma32(bf, F32(2.0 ** -23), -c), eager)


def round_f32(q: Fraction) -> np.float32:
    """A rational rounded once to float32, to nearest, ties to even
    (subnormals kept, overflow to inf); q != 0."""
    sign = -1 if q < 0 else 1
    n, d = abs(q.numerator), q.denominator
    e = n.bit_length() - d.bit_length()
    if Fraction(n, d) < Fraction(2) ** e:
        e -= 1
    e = max(e, -126)                      # the subnormal binade's step
    shift = 23 - e
    num, den = (n << shift, d) if shift >= 0 else (n, d << -shift)
    m, r = divmod(num, den)
    if 2 * r > den or (2 * r == den and m & 1):
        m += 1
    if m >= 1 << 24:
        m >>= 1
        e += 1
    if e > 127:
        return F32(sign * np.inf)
    return F32(sign * float(m) * 2.0 ** (e - 23))


def emulated_div_fast(x: np.float32, d: np.float32, r: np.float32):
    """csrc/analog_update.cu's div_fast, each operation exact and rounded
    once: q0 = RN(x r), then twice nrem = RN(d q - x), q = RN(-nrem r + q).
    Zeros follow IEEE's rules (float64 arithmetic on zeros is exact)."""
    def rn(v: Fraction, zero: float):
        return round_f32(v) if v != 0 else F32(zero)

    fx, fd, fr = Fraction(float(x)), Fraction(float(d)), Fraction(float(r))
    q = rn(fx * fr, float(x) * float(r))
    for _ in range(2):
        fq = Fraction(float(q))
        nrem = rn(fd * fq - fx, float(d) * float(q) - float(x))
        q = rn(-Fraction(float(nrem)) * fr + fq,
               -float(nrem) * float(r) + float(q))
    return q


def div_ok(x: np.float32, hi: np.float32) -> bool:
    a = abs(float(x))
    return a < float(hi) and (a >= 2.0 ** -64 or float(x) == 0.0)


def x_samples(n_random: int, seed: int) -> np.ndarray:
    """float32 x: edges (zeros, subnormal ends, the fast range's ends,
    powers of two, the largest finite, inf, NaN), random bit patterns,
    as many again inside the fast range and a quarter as many subnormal;
    both signs."""
    edges = []
    for v in (0.0, 2.0 ** -149, 2.0 ** -126, 2.0 ** -64, 2.0 ** 64, 1.0,
              2.0 ** 24, 2.0 ** -24):
        f = F32(v)
        edges += [f, np.nextafter(f, F32(0)), np.nextafter(f, F32(np.inf))]
    big = np.finfo(F32).max
    edges += [big, np.nextafter(big, F32(0)), F32(np.inf), F32(np.nan)]
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, n_random, dtype=np.uint64).astype(
        np.uint32)
    inside = ((rng.integers(63, 191, n_random, dtype=np.uint64) << 23)
              | rng.integers(0, 1 << 23, n_random, dtype=np.uint64)).astype(
                  np.uint32)
    sub = rng.integers(1, 1 << 23, n_random // 4, dtype=np.uint64).astype(
        np.uint32)
    xs = np.concatenate([np.array(edges, F32), bits.view(F32),
                         inside.view(F32), sub.view(F32)])
    return np.concatenate([xs, -xs])


def random_divisors(n: int, seed: int):
    """n float32 divisors over the fast division's range: any significand,
    exponents from -32 to 31."""
    rng = np.random.default_rng(seed)
    bits = ((rng.integers(127 - 32, 127 + 32, n) << 23)
            | rng.integers(0, 1 << 23, n)).astype(np.uint32)
    return [float(d) for d in bits.view(F32)]


# the divisors the repo's configs give K1 (dw_min, tau_min, tau_max):
# core/device.py's presets, the training CLI, the paper harness, phase 3;
# then divisors drawn at random
DIVISORS = (1.0, 10.0, 0.9, 1.1, 0.01, 0.001, 1e-4, 2e-4, 0.002, 0.005,
            0.0949, 0.4622, 1e-6, *random_divisors(8, 5))


@pytest.mark.parametrize("d", DIVISORS)
def test_div_fast_exact(d):
    """div_fast == RN(x / d) wherever div_ok lets it run."""
    s = analog_update.launch_scalars(d, 1.0, 1.0, 0.1)
    fd, r, hi = s[0], s[1], s[8]
    checked = 0
    for x in x_samples(600, DIVISORS.index(d)):
        if not div_ok(x, hi):
            continue
        want = (round_f32(Fraction(float(x)) / Fraction(float(fd)))
                if x != 0 else F32(float(x) / float(fd)))
        got = emulated_div_fast(x, fd, r)
        assert bits_equal(np.array([got]), np.array([want])), (x, d)
        checked += 1
    assert checked > 1500


@pytest.mark.parametrize("dw_min,tau_min,tau_max,sigma_c2c,bl", [
    (0.01, 1.0, 1.0, 0.1, 0), (1e-4, 1.0, 1.0, 0.05, 10),
    (0.4622, 1.0, 1.0, 0.2174, 31), (1e-6, 10.0, 10.0, 0.0, 0),
    (1e-40, 1.0, 1.0, 0.1, 0), (0.01, 0.9, 2.0 ** 40, 0.1, 0)])
def test_launch_scalars(dw_min, tau_min, tau_max, sigma_c2c, bl):
    """The wrapper's float32 scalars: the divisors as torch rounds them,
    their reciprocals rounded once, the noise scale from Python's double
    product, the cap (+inf for none) and the fast range, 0 where a
    divisor is outside it."""
    s = analog_update.launch_scalars(dw_min, tau_min, tau_max, sigma_c2c, bl)
    assert all(type(v) is F32 for v in s) and len(s) == 10
    lo, hi = analog_update.DIVISOR_RANGE
    for k, d in enumerate((dw_min, tau_min, tau_max)):
        assert s[2 * k] == F32(d)
        assert s[2 * k + 1] == round_f32(1 / Fraction(float(F32(d))))
    assert s[6] == F32(dw_min * sigma_c2c)
    assert s[7] == (F32(bl) if bl > 0 else F32(np.inf))
    ok = [lo <= float(F32(d)) <= hi for d in (dw_min, tau_min, tau_max)]
    assert s[8] == F32(analog_update.DIV_HI if ok[0] else 0.0)
    assert s[9] == F32(analog_update.DIV_HI if ok[1] and ok[2] else 0.0)


def test_sqrt_table_index():
    """The table's index: |n_q| + 2^23's bits - 0x4B000000 is |n_q| for
    every whole |n_q| < 2^23 and lands at or past 2^23 otherwise (2^23 and
    up, inf, NaN), so only |n_q| < 256 reads the table."""
    nq = np.concatenate([np.arange(1 << 24, dtype=np.float64),
                         [np.inf, np.nan]]).astype(F32)
    for v in (nq, -nq):
        k = ((np.abs(v) + F32(8388608.0)).view(np.uint32)
             - np.uint32(0x4B000000))
        whole = np.abs(v) < 2 ** 23
        assert np.array_equal(k[whole], np.abs(v[whole]).astype(np.uint32))
        assert (k[~whole] >= 1 << 23).all()
