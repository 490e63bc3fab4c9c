"""Replay of the JAX package's property tests (``tests/test_properties.py``)
on the port's device model, plain pulse update and hash RNG."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core import device  # noqa: E402
from repro_torch.kernels import fastrng, ref  # noqa: E402

SETTINGS = settings(max_examples=10, deadline=None)


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.05, 0.6), st.floats(0.0, 0.3))
def test_symmetric_point_property(seed, sigma_pm, sigma_d2d):
    """G(symmetric_point) == 0 and the SP lies inside the dynamic range."""
    cfg = device.DeviceConfig(sigma_pm=sigma_pm, sigma_d2d=sigma_d2d)
    dp = device.sample_device(prng.PRNGKey(seed), (16, 16), cfg, device="cpu")
    sp = device.symmetric_point(dp, cfg)
    _, g = device.fg(sp, dp, cfg)
    assert float(g.abs().max()) < 1e-4
    assert float(sp.abs().max()) <= 1.0 + 1e-6


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.001, 0.2))
def test_stochastic_rounding_unbiased(seed, frac):
    """E[stochastic_round(x)] == x (Assumption 3.4 zero-mean rounding)."""
    key = prng.PRNGKey(seed)
    dw_min, n = 0.01, 40
    shape = (64, 64)
    dw = torch.full(shape, frac * dw_min)
    ones, zeros = torch.ones(shape), torch.zeros(shape)
    acc = 0.0
    for i in range(n):
        ubits = prng.bits(prng.split(prng.fold_in(key, i), 2)[0], shape, "cpu")
        out = ref.analog_update_ref(zeros, dw, ones, zeros, ubits, zeros,
                                    dw_min=dw_min, tau_min=1.0, tau_max=1.0,
                                    sigma_c2c=0.0)
        acc += float(out.mean())
    se = dw_min / np.sqrt(n * 64 * 64)
    assert abs(acc / n - frac * dw_min) < 6 * se


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1))
def test_hash_rng_statistics(seed):
    """Hash RNG: uniform mean/var and near-standard-normal moments."""
    s = torch.tensor([seed & 0xFFFFFFFF, (seed * 7919) & 0xFFFFFFFF])
    u = fastrng.hash_uniform(s, (128, 128), 3, "cpu").numpy()
    assert abs(u.mean() - 0.5) < 0.02
    assert abs(u.var() - 1 / 12) < 0.01
    z = fastrng.hash_normal(s, (128, 128), 5, "cpu").numpy()
    assert abs(z.mean()) < 0.05
    assert abs(z.std() - 1.0) < 0.05


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.01, 0.3))
def test_analog_update_lipschitz(seed, mag):
    """Lemma A.2: the analog increment is q_max-Lipschitz in dw."""
    cfg = device.DeviceConfig(sigma_pm=0.3, sigma_d2d=0.1)
    key = prng.PRNGKey(seed)
    dp = device.sample_device(key, (32, 32), cfg, device="cpu")
    w = prng.uniform(key, (32, 32), -0.5, 0.5, "cpu")
    qp, qm = device.responses(w, dp, cfg)
    q_max = float(torch.maximum(qp, qm).max())
    dw1 = mag * prng.normal(prng.fold_in(key, 1), (32, 32), "cpu")
    dw2 = mag * prng.normal(prng.fold_in(key, 2), (32, 32), "cpu")
    f, g = device.fg(w, dp, cfg)

    def incr(dw):
        return dw * f - dw.abs() * g

    lhs = float(torch.linalg.norm(incr(dw1) - incr(dw2)))
    rhs = q_max * float(torch.linalg.norm(dw1 - dw2))
    assert lhs <= rhs * (1 + 1e-5)
