"""The inverse-CDF tables every normal draw of the port reads: each code
of the table equal to the polynomial, draws through a table bit-equal to
the polynomial on the same bits and within rule 4's 4 ULP of the JAX
package's, the unit-span uniform's float32 sum equal to the FMA, and a
table built inside an op trace left out of it."""
import math

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.roofline.op_cost import OpTrace

jax = pytest.importorskip("jax")


def _polynomial(codes, lo, hi):
    return prng._SQRT2_F32 * prng.erf_inv(prng._to_uniform(codes, lo, hi))


def test_unit_span_uniform_equals_the_fma():
    """Over all 2**23 codes, ``floats + lo`` (the unit-span route, float32
    alone) is bit-equal to the float64 FMA it stands for."""
    codes = torch.arange(2 ** 23, dtype=torch.int64) << 9
    for lo in (0.0, float(np.finfo(np.float32).tiny)):
        fb = (codes >> 9) | 0x3F800000
        floats = fb.to(torch.int32).view(torch.float32) - 1.0
        want = torch.clamp_min(prng.fma(floats, 1.0, lo), lo)
        got = prng._to_uniform(codes, lo, lo + 1.0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_normal_table_equals_the_polynomial_at_every_code():
    """All 2**23 codes: the table, built in pieces, against the polynomial
    over the whole code range at once."""
    table = prng.inverse_cdf_table(prng._NORMAL_LO, 1.0, "cpu")
    codes = torch.arange(2 ** 23, dtype=torch.int64) << 9
    want = _polynomial(codes, prng._NORMAL_LO, 1.0)
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", [(7,), (33, 65)])
def test_table_draws_match_jax(shape):
    """A draw (``bits >> 9`` into the table) gives the polynomial's bits on
    the same uniform, within 4 ULP of ``jax.random.normal`` (ROADMAP rule
    4: XLA-CPU's ``log1p`` under ``erf_inv``); the same for the truncated
    normal the initializers draw."""
    key = prng.PRNGKey(11)
    got = prng.normal(key, shape, "cpu")
    poly = prng._SQRT2_F32 * prng.erf_inv(
        prng.uniform(key, shape, prng._NORMAL_LO, 1.0, "cpu"))
    assert torch.equal(got.view(torch.int32), poly.view(torch.int32))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), shape,
                                        np.float32))
    ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4
    s2 = np.float32(prng._SQRT2_F32)
    lo = prng._f32(math.erf(float(np.float32(-2.0) / s2)))
    hi = prng._f32(math.erf(float(np.float32(2.0) / s2)))
    trunc = prng._SQRT2_F32 * prng.erf_inv(prng.uniform(key, shape, lo, hi,
                                                         "cpu"))
    trunc = torch.clamp(trunc, float(np.nextafter(np.float32(-2), 1)),
                        float(np.nextafter(np.float32(2), -1)))
    assert torch.equal(trunc, prng.truncated_normal(key, -2.0, 2.0, shape,
                                                    "cpu"))


def test_meta_draws_give_shapes():
    out = prng.normal(prng.PRNGKey(1), (4, 6), "meta")
    assert out.shape == (4, 6) and out.dtype == torch.float32
    assert out.device.type == "meta"


def test_table_built_inside_a_trace_is_left_out_of_it(monkeypatch):
    """The first draw on a device builds its table with the dispatch modes
    set aside: the trace holds the draw's ops, no float64 and no build."""
    monkeypatch.setattr(prng, "_ICDF", {})
    with OpTrace() as built:
        prng.normal(prng.PRNGKey(3), (5, 7), "meta")
    with OpTrace() as kept:
        prng.normal(prng.PRNGKey(3), (5, 7), "meta")
    assert [r.name for r in built.records] == [r.name for r in kept.records]
    assert all("float64" not in r.dtypes() for r in built.records)
    assert built.records[-1].short == "aten.index"
