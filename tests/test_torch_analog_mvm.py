"""The port's analog MVM (kernel K3) against the JAX package.

* ``ref.quantize_input`` (the input DAC) against the reference's formula:
  bit-exact.
* ``ref.analog_mvm_ref`` (the plain version of the CUDA kernel) against JAX
  ``ref.analog_mvm_ref`` on the same numpy inputs: every element within one
  ADC step (``out_res * s``, ``s`` the row's ABS_MAX scale) and at least
  99.9 % bit-equal. The quantized inputs agree bit for bit; torch's and
  XLA's matmuls sum in other orders, which can move y across an ADC
  rounding boundary. "One step" allows the rounding of the output to its
  dtype on top: four float32 ULPs of the value (``code * out_res * s`` is
  rounded twice on each side), or one bfloat16 ULP.
* Against the Pallas kernel in interpret mode: the reference's own
  tolerance, two ADC steps times the largest row scale.
* ``ops.analog_mvm`` against JAX ``ops.analog_mvm`` from the same key on
  ragged and rank-3 inputs: one ADC step (threefry normals agree to a few
  ULP, so the noise term does too).
* The CUDA kernel against the plain version, on the card:
  ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.analog_matmul import analog_mvm_pallas  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

IO = dict(inp_res=1 / 126, inp_bound=1.0, out_res=1 / 510, out_bound=12.0,
          out_noise=0.06)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(m, k, n, dtype="float32", seed=0):
    """numpy x (M, K), w (K, N) rounded to ``dtype``, noise (M, N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, n))).astype(np.float32)
    noise = rng.standard_normal((m, n)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return x, w, noise


def _scale(x):
    x = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
    return np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-12))


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x,
                      np.float32)


def _assert_one_step(got, want, s, dtype="float32"):
    """Every element within one ADC step of its row plus the rounding of the
    output to ``dtype`` (module docstring), and at least 99.9 % bit-equal."""
    step = IO["out_res"] * s
    tol = step + np.abs(want) * (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -21)
    gap = np.abs(got - want)
    assert (gap <= tol).all(), (gap / step).max()
    assert (got == want).mean() >= 0.999, (got == want).mean()


@pytest.mark.parametrize("shape", [(64, 128), (33, 47), (5, 300)])
@pytest.mark.parametrize("inp", [(1 / 126, 1.0), (1 / 62, 0.5)])
def test_quantize_input_bit_exact(shape, inp):
    inp_res, inp_bound = inp
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    s = _scale(x)
    got = ref.quantize_input(torch.from_numpy(x), torch.from_numpy(s),
                             inp_res, inp_bound)
    xq = jnp.clip(jnp.asarray(x) / jnp.asarray(s), -inp_bound, inp_bound)
    want = jnp.round(xq * (1.0 / inp_res)) * inp_res
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.abs_max_scale(torch.from_numpy(x)).numpy(), s)


@pytest.mark.parametrize("mkn", [(64, 128, 96), (256, 384, 512), (128, 512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analog_mvm_ref_matches_jax_ref(mkn, dtype):
    x, w, noise = _operands(*mkn, dtype)
    dt = TDT[dtype]
    got = ref.analog_mvm_ref(torch.from_numpy(x).to(dt),
                             torch.from_numpy(w).to(dt),
                             torch.from_numpy(noise), **IO)
    assert got.dtype == dt and tuple(got.shape) == (mkn[0], mkn[2])
    want = jref.analog_mvm_ref(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                               jnp.asarray(noise), **IO)
    _assert_one_step(_f32(got), _f32(want), _scale(x), dtype)


@pytest.mark.parametrize("mkn", [(64, 128, 96), (256, 384, 512), (128, 512, 256)])
def test_analog_mvm_ref_matches_pallas_interpret(mkn):
    x, w, noise = _operands(*mkn, seed=1)
    s = _scale(x)
    got = ref.analog_mvm_ref(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(noise), **IO)
    pallas = analog_mvm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                               jnp.asarray(noise), blocks=(64, 128, 128),
                               interpret=True, **IO)
    tol = float(2 * IO["out_res"] * s.max())
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=tol)


@pytest.mark.parametrize("xshape,wshape", [((5, 33, 47), (47, 29)),
                                           ((2, 5, 48), (48, 32))])
def test_ops_matches_jax_ops_from_the_same_key(xshape, wshape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (0.1 * rng.standard_normal(wshape)).astype(np.float32)
    jkey = jax.random.PRNGKey(0)
    want = np.asarray(jops.analog_mvm(jnp.asarray(x), jnp.asarray(w), jkey,
                                      **IO))
    before = dict(ops.LAUNCHES)
    got = ops.analog_mvm(convert.tensor(x, "cpu"), convert.tensor(w, "cpu"),
                         prng.wrap_key_data(np.asarray(jkey)), **IO)
    assert ops.LAUNCHES == before  # the plain path launches nothing
    assert tuple(got.shape) == xshape[:-1] + wshape[-1:]
    _assert_one_step(got.numpy().reshape(-1, wshape[1]),
                     want.reshape(-1, wshape[1]), _scale(x))


def test_ops_noise_operand_and_dtype():
    """Pre-drawn noise replaces the key; the output keeps x's dtype."""
    x, w, noise = _operands(12, 40, 24, "bfloat16", seed=4)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(3, 4, 40)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = ops.analog_mvm(xt, wt, None, noise=torch.from_numpy(noise), **IO)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 4, 24)
    want = ref.analog_mvm_ref(xt.reshape(12, 40), wt, torch.from_numpy(noise),
                              **IO)
    assert torch.equal(got.reshape(12, 24), want)
    # the key path draws prng.normal at the flattened output shape
    key = prng.PRNGKey(5)
    a = ops.analog_mvm(xt, wt, key, **IO)
    b = ops.analog_mvm(xt, wt, None, noise=prng.normal(key, (12, 24), "cpu"),
                       **IO)
    assert torch.equal(a, b)


def test_kernel_binding_takes_cuda_tensors_only():
    """The binding never runs the plain version in the kernel's place."""
    from repro_torch.kernels.analog_matmul import analog_mvm_cuda

    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        analog_mvm_cuda(x, w, torch.ones(4, 1), torch.zeros(4, 3), **IO)
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        analog_mvm_cuda(x, torch.zeros(7, 3), torch.ones(4, 1),
                        torch.zeros(4, 3), **IO)

