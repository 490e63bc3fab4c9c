"""The port's zero-shifting SP calibration (Algorithm 1, ``core/zs.py``).

* Replay of the JAX package's ``tests/test_zs.py`` on the port, with the
  port's own keys: convergence under both schemes against Thm 2.2 / C.2,
  the Theta(dw_min) error floor, the falling ||G||^2 trace.
* Parity with JAX on the same device parameters and keys, 200 pulses on
  (48, 48), with and without cycle-to-cycle noise: the signs are the same
  draws (threefry bits are bit-exact), but the reference runs under a
  jitted ``lax.scan``, where XLA contracts multiply-adds (ROADMAP, faults),
  and normals differ by a few ULP; so the estimate is held to
  ``atol=1e-6`` (measured 1.8e-7) and the traces to ``rtol=1e-5``
  (measured 7.2e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import device as jdevice  # noqa: E402
from repro.core import zs as jzs  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import device, zs  # noqa: E402


def _setup(dw_min=0.01, key=0):
    cfg = device.DeviceConfig(dw_min=dw_min, sigma_pm=0.4, sigma_d2d=0.1)
    dp = device.sample_device(prng.PRNGKey(key), (48, 48), cfg, device="cpu")
    return cfg, dp, device.symmetric_point(dp, cfg)


@pytest.mark.parametrize("scheme", ["stochastic", "cyclic"])
def test_zs_converges(scheme):
    cfg, dp, sp = _setup()
    w = zs.zs_estimate(prng.PRNGKey(1), torch.zeros(48, 48), dp, cfg, 2000,
                       scheme=scheme)
    rmse = float(torch.sqrt(torch.mean((w - sp) ** 2)))
    assert rmse < 0.1 * float(torch.std(sp, unbiased=False)) + 0.02, rmse


def test_zs_error_floor_scales_with_dwmin():
    """Thm 2.2: the achievable error floor is Theta(dw_min)."""
    floors = []
    for dw_min in (0.04, 0.01):
        cfg, dp, sp = _setup(dw_min)
        w = zs.zs_estimate(prng.PRNGKey(2), torch.zeros(48, 48), dp, cfg,
                           int(40 / dw_min))
        floors.append(float(torch.mean(torch.abs(w - sp))))
    assert floors[1] < floors[0], floors  # finer device -> lower floor


def test_zs_trace_g_decreases():
    cfg, dp, sp = _setup()
    _, trace = zs.zs_estimate_with_trace(prng.PRNGKey(3), torch.zeros(48, 48),
                                         dp, cfg, 1500)
    g = trace["g_sq"]
    assert g.shape == (1500,) and trace["sp_err_sq"].shape == (1500,)
    assert float(g[-1]) < 0.2 * float(g[0])
    n = zs.pulses_to_target(g, float(g[0]) * 0.5)
    assert 0 < n <= 1500
    assert zs.pulses_to_target(g, -1.0) == -1


def _both(sigma_c2c):
    kw = dict(dw_min=0.01, sigma_pm=0.4, sigma_d2d=0.1, sigma_c2c=sigma_c2c)
    jcfg = jdevice.DeviceConfig(**kw)
    jdp = jdevice.sample_device(jax.random.PRNGKey(0), (48, 48), jcfg)
    dp = {k: convert.tensor(v, "cpu") for k, v in jdp.items()}
    return jcfg, jdp, device.DeviceConfig(**kw), dp


@pytest.mark.parametrize("scheme", ["stochastic", "cyclic"])
@pytest.mark.parametrize("sigma_c2c", [0.0, 0.05])
def test_zs_matches_jax(scheme, sigma_c2c):
    jcfg, jdp, cfg, dp = _both(sigma_c2c)
    want = jzs.zs_estimate(jax.random.PRNGKey(1), jnp.zeros((48, 48)), jdp,
                           jcfg, 200, scheme=scheme)
    got = zs.zs_estimate(prng.PRNGKey(1), torch.zeros(48, 48), dp, cfg, 200,
                         scheme=scheme)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)

    jw, jtrace = jzs.zs_estimate_with_trace(
        jax.random.PRNGKey(3), jnp.zeros((48, 48)), jdp, jcfg, 200,
        scheme=scheme)
    w, trace = zs.zs_estimate_with_trace(prng.PRNGKey(3), torch.zeros(48, 48),
                                         dp, cfg, 200, scheme=scheme)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    for k in ("g_sq", "sp_err_sq"):
        np.testing.assert_allclose(trace[k].numpy(), np.asarray(jtrace[k]),
                                   rtol=1e-5, err_msg=k)
    assert zs.pulses_to_target(trace["g_sq"], float(trace["g_sq"][0]) * 0.9) \
        == jzs.pulses_to_target(jtrace["g_sq"], float(jtrace["g_sq"][0]) * 0.9)


def test_zs_zero_pulses_and_unknown_scheme():
    cfg, dp, _ = _setup()
    w0 = torch.full((48, 48), 0.25)
    assert torch.equal(zs.zs_estimate(prng.PRNGKey(0), w0, dp, cfg, 0), w0)
    w, trace = zs.zs_estimate_with_trace(prng.PRNGKey(0), w0, dp, cfg, 0)
    assert torch.equal(w, w0) and trace["g_sq"].shape == (0,)
    with pytest.raises(ValueError):
        zs.zs_estimate(prng.PRNGKey(0), w0, dp, cfg, 3, scheme="bogus")
