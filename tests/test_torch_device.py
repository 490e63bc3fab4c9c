"""The port's device models and pulse engine against the JAX package.

Tolerances: ``rtol=2e-6`` where a value goes through a threefry normal or
``exp`` (XLA-CPU and torch agree to a few ULP there); bit-exact where both
sides run the same float32 ops in the same order (responses, F/G, the
symmetric point, the fused update from injected noise).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import device as jdev  # noqa: E402
from repro.core import pulse as jpulse  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import device, pulse  # noqa: E402

PRESET_NAMES = sorted(jdev.PRESETS)


def _tkey(jkey):
    return prng.wrap_key_data(np.asarray(jkey))


def _tdev(dp):
    return {k: torch.from_numpy(np.array(v)) for k, v in dp.items()}


def test_presets_mirror_the_reference():
    assert sorted(device.PRESETS) == PRESET_NAMES
    for name in PRESET_NAMES:
        assert (dataclasses.asdict(device.PRESETS[name])
                == dataclasses.asdict(jdev.PRESETS[name])), name
        assert device.PRESETS[name].num_states == jdev.PRESETS[name].num_states


@pytest.mark.parametrize("method", ["threefry", "hash"])
@pytest.mark.parametrize("cfg", [
    jdev.PRESETS["reram_om"],
    jdev.DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, ref_mean=0.3,
                      ref_std=0.2),
    jdev.DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.0, tau_min=0.5,
                      ref_mean=-0.1, ref_std=0.05),
], ids=["reram_om", "ref_offset", "asym_range"])
def test_sample_device_matches_jax(method, cfg):
    jkey = jax.random.PRNGKey(4)
    want = jdev.sample_device(jkey, (48, 40), cfg, method=method)
    tcfg = device.DeviceConfig(**{f: getattr(cfg, f) for f in
                                  cfg.__dataclass_fields__})
    got = device.sample_device(_tkey(jkey), (48, 40), tcfg, method=method,
                               device="cpu")
    for k in ("gamma", "rho"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-6, atol=1e-7, err_msg=k)
    # the symmetric point of the same parameters is computed bit-exactly
    sp_t = device.symmetric_point(_tdev(want), tcfg).numpy()
    np.testing.assert_array_equal(sp_t, np.asarray(jdev.symmetric_point(want, cfg)))


@pytest.mark.parametrize("kind", ["softbounds", "linear", "exp"])
def test_responses_fg_symmetric_point_match_jax(kind):
    cfg = jdev.DeviceConfig(kind=kind, sigma_pm=0.3, sigma_d2d=0.1)
    tcfg = device.DeviceConfig(kind=kind, sigma_pm=0.3, sigma_d2d=0.1)
    dp = jdev.sample_device(jax.random.PRNGKey(0), (32, 32), cfg)
    w = np.random.default_rng(0).uniform(-1.2, 1.2, (32, 32)).astype(np.float32)
    tw, tdp = torch.from_numpy(w), _tdev(dp)
    exact = kind != "exp"  # exp goes through XLA's and torch's own exp
    # (G is a difference of close values: its ULP-level error is absolute)
    cmp = (np.testing.assert_array_equal if exact else
           lambda a, b: np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-6))
    for a, b in zip(device.responses(tw, tdp, tcfg),
                    jdev.responses(jnp.asarray(w), dp, cfg)):
        cmp(a.numpy(), np.asarray(b))
    for a, b in zip(device.fg(tw, tdp, tcfg), jdev.fg(jnp.asarray(w), dp, cfg)):
        cmp(a.numpy(), np.asarray(b))
    cmp(device.symmetric_point(tdp, tcfg).numpy(),
        np.asarray(jdev.symmetric_point(dp, cfg)))
    # G vanishes at the symmetric point (replay of test_device.py)
    sp = device.symmetric_point(tdp, tcfg)
    _, g = device.fg(sp, tdp, tcfg)
    assert float(g.abs().max()) < 1e-5


@pytest.mark.parametrize("preset", ["reram_hfo2", "reram_om", "softbounds_2000",
                                    "ecram", "ideal"])
def test_fused_generic_and_kernel_path_match_jax(preset):
    """``pulse._fused_generic`` (the responses() path, with its 1e-4 floor)
    and the kernel path (``ops``, no floor) from the same injected noise,
    against the JAX package's ``_fused_generic``."""
    cfg = jdev.PRESETS[preset]
    tcfg = device.PRESETS[preset]
    shape = (64, 96)
    rng = np.random.default_rng(1)
    lim = 0.8 * min(cfg.tau_min, cfg.tau_max)
    w = rng.uniform(-lim, lim, shape).astype(np.float32)
    dw = (3.0 * cfg.dw_min * rng.standard_normal(shape)).astype(np.float32)
    dp = jdev.sample_device(jax.random.PRNGKey(2), shape, cfg)
    ubits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    zeta = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jpulse._fused_generic(
        jnp.asarray(w), jnp.asarray(dw), dp, cfg, None, bl=10,
        noise=(jnp.asarray(ubits), jnp.asarray(zeta))))
    noise = (torch.from_numpy(ubits.astype(np.int64)), torch.from_numpy(zeta))
    tw, tdw, tdp = torch.from_numpy(w), torch.from_numpy(dw), _tdev(dp)
    got = pulse._fused_generic(tw, tdw, tdp, tcfg, None, bl=10, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    via_ops = pulse.analog_update(tw, tdw, tdp, tcfg, None, bl=10, noise=noise)
    np.testing.assert_allclose(via_ops.numpy(), want, atol=1e-6)


def test_pulse_train_and_zs_step_match_jax():
    cfg = jdev.DeviceConfig(dw_min=0.05, sigma_pm=0.3, sigma_d2d=0.1,
                            sigma_c2c=0.1)
    tcfg = device.DeviceConfig(dw_min=0.05, sigma_pm=0.3, sigma_d2d=0.1,
                               sigma_c2c=0.1)
    shape = (16, 24)
    dp = jdev.sample_device(jax.random.PRNGKey(0), shape, cfg)
    rng = np.random.default_rng(2)
    w = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    dw = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    jkey = jax.random.PRNGKey(3)
    want = jpulse.analog_update(jnp.asarray(w), jnp.asarray(dw), dp, cfg, jkey,
                                bl=4, mode="train")
    got = pulse.analog_update(torch.from_numpy(w), torch.from_numpy(dw),
                              _tdev(dp), tcfg, _tkey(jkey), bl=4, mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-7)
    eps = np.where(rng.random(shape) < 0.5, -0.05, 0.05).astype(np.float32)
    want = jpulse.zs_step(jnp.asarray(w), jnp.asarray(eps), dp, cfg, jkey)
    got = pulse.zs_step(torch.from_numpy(w), torch.from_numpy(eps), _tdev(dp),
                        tcfg, _tkey(jkey))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-7)
