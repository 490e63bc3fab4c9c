"""The port's convnets (``repro_torch.models.convnets``) against the JAX
package's, on the CPU.

* Init: both kinds' weights drawn from the same key, at the reference's
  shapes (LeNet-5's kernels HWIO), within a few ULP (the FCN's standard).
* LeNet-5 at full width on a batch of 8: logits, loss and every gradient.
  XLA-CPU and torch (oneDNN) sum the convolution in different orders, so
  the test holds them to ``atol = 4e-6 * max|value|`` per leaf (measured:
  up to 1.2e-6, conv1's bias gradient), not to bit-equality.
* The flatten before fc1 reads NHWC rows (h, w, c), as the reference's
  ``reshape`` does; the NCHW order would read another feature.
* Max-pool gradient at a tie (tanh saturated to exactly 1.0): both send a
  window's gradient to its first maximum in row-major order.
* The FCN branch still matches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import convnets as jconv  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.models import convnets  # noqa: E402

REL = 4e-6  # of the leaf's largest magnitude


def _params(kind):
    jp = jconv.init_convnet(jax.random.PRNGKey(0), jconv.ConvNetConfig(kind=kind))
    tp = {k: {kk: torch.from_numpy(np.array(v)) for kk, v in d.items()}
          for k, d in jp.items()}
    return jp, tp


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _close(got, want, label):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=label)


@pytest.mark.parametrize("kind", ["fcn", "lenet5"])
def test_init_matches_jax(kind):
    jp = jconv.init_convnet(jax.random.PRNGKey(3), jconv.ConvNetConfig(kind=kind))
    tp = convnets.init_convnet(prng.PRNGKey(3), convnets.ConvNetConfig(kind=kind),
                               "cpu")
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k]["w"].shape) == jp[k]["w"].shape, k
        np.testing.assert_allclose(tp[k]["w"].numpy(), np.asarray(jp[k]["w"]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(tp[k]["b"].numpy(), np.asarray(jp[k]["b"]))
    if kind == "lenet5":
        assert [tuple(tp[k]["w"].shape) for k in tp] == [
            (5, 5, 1, 16), (5, 5, 16, 32), (7 * 7 * 32, 512), (512, 128),
            (128, 10)]


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        convnets.init_convnet(prng.PRNGKey(0), convnets.ConvNetConfig(kind="vgg"),
                              "cpu")


@pytest.mark.parametrize("kind", ["fcn", "lenet5"])
def test_logits_loss_and_grads_match_jax(kind):
    jp, tp = _params(kind)
    x, y = _batch()
    jcfg, tcfg = jconv.ConvNetConfig(kind=kind), convnets.ConvNetConfig(kind=kind)
    jlogits = jconv.convnet_logits(jp, jnp.asarray(x), jcfg)
    tlogits = convnets.convnet_logits(tp, torch.from_numpy(x), tcfg)
    _close(tlogits.numpy(), jlogits, "logits")

    jloss_fn, tloss_fn = jconv.make_loss_fn(jcfg), convnets.make_loss_fn(tcfg)
    (jloss, jaux), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, None)
    for d in tp.values():
        for v in d.values():
            v.requires_grad_(True)
    tloss, taux = tloss_fn(tp, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)}, None)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    for k in jp:
        for kk in ("w", "b"):
            _close(tp[k][kk].grad.numpy(), jg[k][kk], f"grad {k}/{kk}")


def test_lenet5_flatten_reads_nhwc_rows():
    """fc1 one-hot on row (h, w, c) = (2, 5, 3) of the NHWC flatten: the
    logit is tanh(tanh(pooled[:, 2, 5, 3])) of the reference's pipeline."""
    jp, tp = _params("lenet5")
    x, _ = _batch(4, seed=1)
    h, w, c = 2, 5, 3
    row = (h * 7 + w) * 32 + c
    for k, n in (("fc1", (1568, 512)), ("fc2", (512, 128)), ("out", (128, 10))):
        tp[k]["w"] = torch.zeros(n)
        tp[k]["b"] = torch.zeros(n[1])
    tp["fc1"]["w"][row, 0] = 1.0
    tp["fc2"]["w"][0, 0] = 1.0
    tp["out"]["w"][0, 0] = 1.0
    logits = convnets.convnet_logits(tp, torch.from_numpy(x),
                                     convnets.ConvNetConfig(kind="lenet5"))
    a = jnp.tanh(jconv._conv2d(jnp.asarray(x), jp["conv1"]["w"], jp["conv1"]["b"]))
    a = jnp.tanh(jconv._conv2d(jconv._maxpool(a), jp["conv2"]["w"],
                               jp["conv2"]["b"]))
    pooled = np.asarray(jconv._maxpool(a))
    assert pooled.shape == (4, 7, 7, 32)
    want = np.tanh(np.tanh(pooled[:, h, w, c]))
    _close(logits[:, 0].detach().numpy(), want, "NHWC feature")
    # the NCHW flatten's row `row` is another feature
    nchw = pooled.transpose(0, 3, 1, 2).reshape(4, -1)[:, row]
    assert np.abs(np.tanh(np.tanh(nchw)) - want).max() > 1e-3
    assert not np.any(logits[:, 1:].detach().numpy())


def test_conv_and_pool_layouts_match_jax():
    """``_conv2d`` (NHWC x HWIO, SAME) and ``_maxpool`` (2x2 VALID)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    w = (0.2 * rng.standard_normal((5, 5, 3, 16))).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jconv._conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = convnets._conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 28, 28, 16)
    _close(got, want, "conv")
    pool = convnets._maxpool(torch.from_numpy(want.copy())).numpy()
    assert pool.shape == (2, 14, 14, 16)
    np.testing.assert_array_equal(pool, np.asarray(jconv._maxpool(jnp.asarray(want))))


def test_maxpool_gradient_at_ties_matches_jax():
    """tanh saturates to exactly 1.0 in float32, so pooled windows tie; a
    tied window's gradient goes to its first maximum in both packages."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x[:, :4] = rng.choice([20.0, 30.0, -1.0], size=x[:, :4].shape)
    assert np.mean(np.tanh(x[:, :4]) == 1.0) > 0.5
    cot = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    a = np.array(jnp.tanh(jnp.asarray(x)))  # one input for both packages
    t = torch.from_numpy(a.copy())

    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jconv._maxpool(v) * cot))(jnp.asarray(a)))
    t.requires_grad_(True)
    torch.sum(convnets._maxpool(t) * torch.from_numpy(cot)).backward()
    got = t.grad.numpy()
    # the gradient reaches exactly one element of each window
    assert np.count_nonzero(got) == cot.size
    np.testing.assert_array_equal(got, want)
