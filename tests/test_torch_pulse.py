"""Replay of the JAX package's ``tests/test_pulse.py`` on the port: the
pulse engine's Assumption 3.4 statistics, mode agreement and bounds, with
the port's own keys (statistical bounds as in the reference)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.core import device, pulse  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

CFG = device.DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.0)


def _dp(shape=(64, 64), key=0):
    return device.sample_device(prng.PRNGKey(key), shape, CFG, device="cpu")


def test_discretization_unbiased():
    """E[b_k] = 0: stochastic rounding matches the exact update in mean."""
    dp = _dp()
    w = torch.zeros(64, 64)
    dw = torch.full((64, 64), 0.0033)
    exact = ref.analog_update_expected_ref(w, dw, dp["gamma"], dp["rho"],
                                           tau_min=CFG.tau_min,
                                           tau_max=CFG.tau_max)
    n = 200
    acc = sum(pulse.analog_update(w, dw, dp, CFG, prng.PRNGKey(i))
              for i in range(n))
    assert abs(float(torch.mean(acc / n - exact))) < 2e-4


def test_discretization_variance_scales():
    """Var[b_k] = dw_min^2 p(1-p): p = 0.2 vs 0.4 gives a ratio of 1.5."""
    dp = {"gamma": torch.ones(128, 128), "rho": torch.zeros(128, 128)}
    w = torch.zeros(128, 128)
    variances = []
    for mag in (0.002, 0.004):
        dw = torch.full((128, 128), mag)
        samples = np.stack([
            (pulse.analog_update(w, dw, dp, CFG, prng.PRNGKey(i)) - w).numpy()
            for i in range(64)])
        variances.append(np.var(samples, axis=0).mean())
    ratio = variances[1] / variances[0]
    assert 1.3 < ratio < 1.7, ratio


def test_bounds_respected():
    dp = _dp((32, 32))
    out = pulse.analog_update(torch.full((32, 32), 0.99),
                              torch.full((32, 32), 0.5), dp, CFG,
                              prng.PRNGKey(0))
    assert float(out.max()) <= CFG.tau_max + 1e-6


def test_pulse_train_matches_fused_small_updates():
    dp = _dp((128, 128), key=5)
    w = 0.2 * torch.ones(128, 128)
    dw = torch.full((128, 128), 0.03)
    n = 50
    accs = {mode: sum(pulse.analog_update(w, dw, dp, CFG, prng.PRNGKey(i),
                                          bl=10, mode=mode)
                      for i in range(n)) for mode in ("fused", "train")}
    diff = float(torch.mean(torch.abs(accs["fused"] / n - accs["train"] / n)))
    assert diff < 2e-3, diff


def test_zs_step_moves_toward_sp():
    cfg = device.DeviceConfig(dw_min=0.01, sigma_pm=0.5, sigma_d2d=0.1)
    dp = device.sample_device(prng.PRNGKey(9), (64, 64), cfg, device="cpu")
    sp = device.symmetric_point(dp, cfg)
    w = torch.zeros(64, 64)
    d0 = float(torch.mean(torch.abs(w - sp)))
    for i in range(400):
        up = prng.bernoulli(prng.PRNGKey(i), 0.5, w.shape)
        w = pulse.zs_step(w, torch.where(up, 1.0, -1.0) * cfg.dw_min, dp, cfg)
    d1 = float(torch.mean(torch.abs(w - sp)))
    assert d1 < 0.5 * d0, (d0, d1)
