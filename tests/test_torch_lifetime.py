"""The port's lifetime subsystem against the JAX package's, on the CPU.

* The reference's ``tests/test_lifetime.py`` replayed on the port, except
  ``test_parse_age_units``, which tests the serving CLI (``launch/serve``,
  not ported yet). "Across jit" becomes "across calls".
* Same inputs through both packages: ``apply_lifetime`` and
  ``program_weights`` within ``rtol=4e-6`` plus ``atol=1e-6 * amax|w|``.
  The hash normals agree to a few float32 ULP (XLA-CPU's ``sqrt`` and
  ``log`` against torch's), and ``exp(-nu * log(t/t0))`` carries that
  into the result scaled by ``log(t/t0)`` (<= 15 at one year on
  ``pcm_gst``). ``reference_input`` is bit-equal; ``weight_signature``
  within ``rtol=1e-6`` (another summation order).
* At t0, the port's GDC identity is bit-exact (``alpha == 1.0``, weights
  bit-equal); across the two packages ``alpha`` is 1 within 1e-6.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.device import PRESETS as JPRESETS  # noqa: E402
from repro.lifetime import drift as jdrift  # noqa: E402
from repro.lifetime import gdc as jgdc  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.device import PRESETS, DeviceConfig  # noqa: E402
from repro_torch.lifetime import (age_params, apply_lifetime,  # noqa: E402
                                  correct_params, lifetime_cfg_map, path_key,
                                  program_weights, signature_tree,
                                  weight_signature)
from repro_torch.lifetime import drift as ldrift  # noqa: E402
from repro_torch.lifetime import gdc as lgdc  # noqa: E402

PCM = PRESETS["pcm_gst"]
KEY = prng.PRNGKey(7)
YEAR = 31557600.0


def _normal(shape, seed=7, scale=1.0):
    return torch.from_numpy(
        (scale * np.random.default_rng(seed).standard_normal(shape))
        .astype(np.float32))


def _jax_cfg(cfg):
    from repro.core.device import DeviceConfig as JDev

    import dataclasses
    return JDev(**dataclasses.asdict(cfg))


# ------------------------------------------------------- replayed reference


def test_drift_exponent_recovered_by_regression():
    cfg = DeviceConfig(kind="softbounds", drift_nu=0.06, drift_nu_std=0.02,
                       drift_t0=20.0)
    w = torch.ones((256, 256))
    ts = np.array([cfg.drift_t0 * 10.0 ** k for k in range(7)])
    means = np.array([float(torch.mean(apply_lifetime(w, t, KEY, cfg)))
                      for t in ts])
    x = np.log(ts / cfg.drift_t0)
    slope = np.polyfit(x[1:], np.log(means[1:]), 1)[0]
    assert -slope == pytest.approx(cfg.drift_nu, abs=0.015)


def test_drift_t0_is_bit_exact_noop():
    w = _normal((64, 48))
    out = apply_lifetime(w, PCM.drift_t0, KEY, PCM)
    assert torch.equal(out, w)


def test_drift_monotone_and_clamped_below_t0():
    cfg = DeviceConfig(kind="softbounds", drift_nu=0.06, drift_t0=20.0)
    w = torch.ones((128, 128))
    ms = [float(torch.mean(apply_lifetime(w, t, KEY, cfg)))
          for t in (20.0, 2e2, 2e3, 2e4)]
    assert all(a > b for a, b in zip(ms, ms[1:]))
    early = apply_lifetime(w, 1.0, KEY, cfg)
    ref = apply_lifetime(w, cfg.drift_t0 + 0.0, KEY, cfg)
    assert torch.equal(early, ref)


def test_drift_deterministic_across_calls():
    w = _normal((32, 32))
    a = apply_lifetime(w, 1e6, KEY, PCM)
    b = apply_lifetime(w, 1e6, KEY, PCM)
    assert torch.equal(a, b)


def test_read_noise_scales_with_tensor_amplitude():
    cfg = DeviceConfig(kind="softbounds", read_noise=0.01, drift_t0=1.0)
    for amp in (0.05, 5.0):
        w = amp * torch.ones((512, 512))
        noise = apply_lifetime(w, 100.0, KEY, cfg).numpy() - amp
        assert np.std(noise) == pytest.approx(cfg.read_noise * amp, rel=0.1)


def test_program_weights_state_dependent_sigma():
    cfg = DeviceConfig(kind="softbounds", tau_min=100.0, tau_max=100.0,
                       prog_noise=0.01, prog_noise_slope=0.08, prog_rounds=1)
    for target in (0.0, 0.5, 2.0):
        w = torch.full((512, 512), target)
        err = program_weights(w, KEY, cfg).numpy() - target
        want = cfg.prog_noise + cfg.prog_noise_slope * abs(target)
        assert np.std(err) == pytest.approx(want, rel=0.1)


def test_program_weights_verify_rounds_contract_error():
    base = dict(kind="softbounds", tau_min=100.0, tau_max=100.0,
                prog_noise=0.02, prog_noise_slope=0.1, read_noise=0.002)
    w = _normal((256, 256))
    rms = []
    for rounds in (1, 3):
        cfg = DeviceConfig(prog_rounds=rounds, **base)
        rms.append(float(torch.sqrt(torch.mean(
            (program_weights(w, KEY, cfg) - w) ** 2))))
    assert rms[1] < 0.35 * rms[0], rms


def test_program_weights_noop_without_noise():
    w = _normal((16, 16))
    assert program_weights(w, KEY, DeviceConfig(kind="softbounds")) is w


def test_signature_chunking_invariant():
    w = _normal((37, 19))
    direct = float(weight_signature(w, chunks=1))
    for chunks in (2, 4, 8):
        assert float(weight_signature(w, chunks=chunks)) == \
            pytest.approx(direct, rel=1e-5)


def test_gdc_alpha_recovers_global_scale():
    w = _normal((64, 64))
    params = {"stack": {"w": w}}
    sig0 = {p: float(v) for p, v in signature_tree(params, ("stack/w",)).items()}
    corrected, scales = correct_params({"stack": {"w": 0.425 * w}}, sig0)
    assert scales["stack/w"] == pytest.approx(1.0 / 0.425, rel=1e-4)
    assert float((corrected["stack"]["w"] - w).abs().max()) < 1e-4


def test_gdc_t0_bit_exact_roundtrip():
    w = _normal((48, 32))
    params = {"w": w}
    sig = signature_tree(params, ("w",))
    stored = json.loads(json.dumps({p: float(v) for p, v in sig.items()}))
    corrected, scales = correct_params(params, stored)
    assert scales["w"] == 1.0
    assert torch.equal(corrected["w"], w)


def test_gdc_reduces_drift_error_at_one_year():
    w = _normal((128, 128), scale=0.05)
    params = {"w": w}
    sig0 = {p: float(v) for p, v in signature_tree(params, ("w",)).items()}
    aged = {"w": apply_lifetime(w, PCM.drift_t0 + YEAR, path_key(KEY, "w"),
                                PCM)}
    corrected, scales = correct_params(aged, sig0)
    err_raw = float(torch.mean(torch.abs(aged["w"] - w)))
    err_gdc = float(torch.mean(torch.abs(corrected["w"] - w)))
    assert scales["w"] > 1.5
    assert err_gdc < 0.5 * err_raw


def test_age_params_only_touches_mapped_paths():
    w = _normal((8, 8))
    b = torch.ones(8)
    tree = {"layer": {"w": w, "b": b}}
    out = age_params(tree, {"layer/w": PCM}, YEAR, KEY)
    assert not torch.equal(out["layer"]["w"], w)
    assert out["layer"]["b"] is b


def test_path_key_distinct_per_path():
    k1 = path_key(KEY, "stack.0.attn.wq")
    k2 = path_key(KEY, "stack.1.attn.wq")
    assert not torch.equal(k1, k2)


def test_presets_lifetime_fields_are_sane():
    for cfg in PRESETS.values():
        assert cfg.drift_nu >= 0.0 and cfg.drift_nu_std >= 0.0
        assert cfg.drift_t0 > 0.0 and cfg.prog_rounds >= 1
        assert cfg.read_noise >= 0.0 and cfg.prog_noise >= 0.0
    assert PRESETS["ideal"].drift_nu == 0.0
    assert not ldrift.has_lifetime(PRESETS["ideal"])
    assert ldrift.has_lifetime(PRESETS["pcm_gst"])


def test_reference_input_fixed_and_positive():
    x = lgdc.reference_input(257, "cpu").numpy()
    y = lgdc.reference_input(257, "cpu").numpy()
    assert np.array_equal(x, y)
    assert (x >= 0.5).all() and (x < 1.0).all()


# --------------------------------------------------- the port against JAX


def _close_to_jax(got, want, amax):
    np.testing.assert_allclose(got, want, rtol=4e-6, atol=1e-6 * amax)


@pytest.mark.parametrize("preset", ["pcm_gst", "reram_om", "ecram"])
@pytest.mark.parametrize("age", [0.0, 1e3, YEAR])
def test_apply_lifetime_matches_jax(preset, age):
    w = _normal((96, 80), seed=3, scale=0.1)
    cfg = PRESETS[preset]
    t = cfg.drift_t0 + age
    got = apply_lifetime(w, t, prng.PRNGKey(11), cfg).numpy()
    want = np.asarray(jdrift.apply_lifetime(
        jnp.asarray(w.numpy()), t, jax.random.PRNGKey(11), JPRESETS[preset]))
    if age == 0.0:
        assert np.array_equal(got, want) and np.array_equal(got, w.numpy())
    _close_to_jax(got, want, float(np.abs(w.numpy()).max()))


def test_apply_lifetime_bf16_matches_jax():
    w = _normal((40, 24), seed=4, scale=0.1)
    got = apply_lifetime(w.to(torch.bfloat16), PCM.drift_t0 + YEAR, KEY, PCM)
    want = jdrift.apply_lifetime(jnp.asarray(w.numpy()).astype(jnp.bfloat16),
                                 PCM.drift_t0 + YEAR, jax.random.PRNGKey(7),
                                 JPRESETS["pcm_gst"])
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # one bf16 rounding of values that agree to a few f32 ULP
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("preset", ["pcm_gst", "reram_hfo2", "softbounds_2000"])
def test_program_weights_matches_jax(preset):
    w = _normal((64, 48), seed=5, scale=0.3)
    got = program_weights(w, prng.PRNGKey(13), PRESETS[preset]).numpy()
    want = np.asarray(jdrift.program_weights(
        jnp.asarray(w.numpy()), jax.random.PRNGKey(13), JPRESETS[preset]))
    _close_to_jax(got, want, float(np.abs(w.numpy()).max()))


def test_path_key_and_cfg_map_match_jax():
    for name in ("fc1/w", "blocks/0/mlp/wi", "w"):
        assert prng.key_data(path_key(KEY, name)).tolist() == \
            np.asarray(jdrift.path_key(jax.random.PRNGKey(7), name)).tolist()
    from repro_torch.core.plan import TilePolicy
    from repro_torch.core.tile import TileBank

    pol_a = TilePolicy.of("erider", "pcm_gst", name="a")
    pol_d = TilePolicy(None, name="digital")
    bank = TileBank.from_classes({}, (("ga", ("x/w", "y/w")), ("gd", ("z",))),
                                 (), {"ga": pol_a, "gd": pol_d})
    cmap = lifetime_cfg_map({}, bank, PRESETS["ideal"])
    assert cmap == {"x/w": PCM, "y/w": PCM}
    legacy = TileBank.from_classes({}, (("g", ("q",)),), ())
    assert lifetime_cfg_map({}, legacy, PRESETS["ecram"]) == \
        {"q": PRESETS["ecram"]}


def test_age_params_matches_jax():
    rng = np.random.default_rng(8)
    tree = {"a": {"w": (0.1 * rng.standard_normal((16, 12))).astype(np.float32),
                  "b": np.ones(12, np.float32)},
            "c": [(0.2 * rng.standard_normal((8, 8))).astype(np.float32)]}
    cmap = {"a/w": "pcm_gst", "c/0": "reram_om"}
    got = age_params(jax.tree.map(torch.from_numpy, tree),
                     {p: PRESETS[c] for p, c in cmap.items()}, YEAR, KEY)
    want = jdrift.age_params(jax.tree.map(jnp.asarray, tree),
                             {p: JPRESETS[c] for p, c in cmap.items()}, YEAR,
                             jax.random.PRNGKey(7))
    for g, w in ((got["a"]["w"], want["a"]["w"]), (got["c"][0], want["c"][0])):
        _close_to_jax(g.numpy(), np.asarray(w), float(np.abs(np.asarray(w)).max()))
    assert np.array_equal(got["a"]["b"].numpy(), tree["a"]["b"])


@pytest.mark.parametrize("n", [1, 7, 257, 4864])
def test_reference_input_bit_equal_to_jax(n):
    assert np.array_equal(lgdc.reference_input(n, "cpu").numpy(),
                          np.asarray(jgdc.reference_input(n)))


@pytest.mark.parametrize("shape", [(37, 19), (64, 64), (3, 8, 5), (50,), (7, 3)])
@pytest.mark.parametrize("chunks", [1, 4])
def test_weight_signature_matches_jax(shape, chunks):
    w = _normal(shape, seed=9)
    got = float(weight_signature(w, chunks))
    want = float(jgdc.weight_signature(jnp.asarray(w.numpy()), chunks))
    assert got == pytest.approx(want, rel=1e-6)


def test_gdc_t0_identity_across_frameworks():
    """A signature written by one package and checked by the other at t0
    gives alpha within 1e-6 of 1 (another summation order); within the
    port it is exactly 1 and the weights stay bit-equal."""
    w = _normal((96, 64), seed=10, scale=0.05)
    params = {"l": {"w": w}}
    jparams = {"l": {"w": jnp.asarray(w.numpy())}}
    sig_t = {p: float(v) for p, v in signature_tree(params, ("l/w",)).items()}
    sig_j = {p: float(v) for p, v in
             jgdc.signature_tree(jparams, ("l/w",)).items()}
    _, port_from_jax = correct_params(params, sig_j)
    _, jax_from_port = jgdc.correct_params(jparams, sig_t)
    assert abs(port_from_jax["l/w"] - 1.0) <= 1e-6
    assert abs(jax_from_port["l/w"] - 1.0) <= 1e-6
    out, own = correct_params(params, json.loads(json.dumps(sig_t)))
    assert own["l/w"] == 1.0 and torch.equal(out["l"]["w"], w)


def test_correct_in_graph_matches_correct_params():
    w = _normal((64, 32), seed=12, scale=0.1)
    sig0 = {"w": float(weight_signature(w))}
    aged = {"w": 0.7 * w, "b": torch.ones(3)}
    host, _ = correct_params(aged, sig0)
    graph = lgdc.correct_in_graph(aged, sig0)
    np.testing.assert_allclose(graph["w"].numpy(), host["w"].numpy(),
                               rtol=1e-6)
    assert graph["b"] is aged["b"]
    want = jgdc.correct_in_graph({"w": jnp.asarray(0.7 * w.numpy())}, sig0)
    np.testing.assert_allclose(graph["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-5)
