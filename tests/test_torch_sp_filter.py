"""The port's SP-tracking filter (kernel K2) against the JAX package.

* ``ref.sp_filter_ref`` (the plain version of the CUDA kernel) against JAX
  ``ref.sp_filter_ref`` on the same numpy inputs: ``q_new`` bit-equal (both
  divide, op by op), the two sums within ``rtol=1e-6`` (torch and XLA sum
  in other orders), with symmetric and asymmetric ``tau``, q/p in float32
  and bfloat16.
* Against the Pallas kernel in interpret mode: ``atol=1e-6`` on ``q_new``
  and ``rtol=1e-5`` on the sums, the reference's own tolerances (the Pallas
  body multiplies by reciprocals, and the interpreter's jitted code
  contracts multiply-adds).
* ``ops.sp_filter`` against JAX ``ops.sp_filter`` on ragged and rank-3
  inputs (the JAX wrapper pads to blocks; the port does not).
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
from repro.kernels.sp_filter import sp_filter_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TAUS = {"symmetric": (1.0, 1.0), "asymmetric": (0.7, 1.3)}


def _operands(shape, dtype="float32", seed=0):
    """numpy q, p (rounded to ``dtype``), gamma, rho."""
    rng = np.random.default_rng(seed)
    q = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    p = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    gamma = np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32)
    rho = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return q, p, gamma, rho


def _kw(tau, eta=0.3):
    tau_min, tau_max = TAUS[tau]
    return dict(eta=eta, tau_min=tau_min, tau_max=tau_max)


def _torch(o, dtype="float32"):
    q, p, gamma, rho = (torch.from_numpy(a) for a in o)
    return q.to(TDT[dtype]), p.to(TDT[dtype]), gamma, rho


@pytest.mark.parametrize("shape", [(256, 512), (512, 1024)])
@pytest.mark.parametrize("tau", list(TAUS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_filter_ref_matches_jax_ref(shape, tau, dtype):
    o = _operands(shape, dtype)
    q_new, gp, err = ref.sp_filter_ref(*_torch(o, dtype), **_kw(tau))
    assert q_new.dtype == TDT[dtype] and q_new.shape == shape
    assert gp.dtype == err.dtype == torch.float32 and gp.ndim == err.ndim == 0
    jq, jp, jg, jr = (jnp.asarray(a) for a in o)
    want = jref.sp_filter_ref(jq.astype(dtype), jp.astype(dtype), jg, jr,
                              **_kw(tau))
    np.testing.assert_array_equal(q_new.float().numpy(),
                                  np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("shape", [(256, 512), (512, 1024)])
@pytest.mark.parametrize("tau", list(TAUS))
def test_sp_filter_ref_matches_pallas_interpret(shape, tau):
    o = _operands(shape, seed=1)
    q_new, gp, err = ref.sp_filter_ref(*_torch(o), **_kw(tau))
    want = sp_filter_pallas(*(jnp.asarray(a) for a in o), interpret=True,
                            **_kw(tau))
    np.testing.assert_allclose(q_new.numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-5)


@pytest.mark.parametrize("shape", [(33, 97), (3, 33, 97), (50,)])
def test_ops_matches_jax_ops_on_ragged_shapes(shape):
    o = _operands(shape, seed=2)
    kw = _kw("asymmetric", eta=0.1)
    before = dict(ops.LAUNCHES)
    q_new, gp, err = ops.sp_filter(*_torch(o), **kw)
    assert ops.LAUNCHES == before  # the plain path launches nothing
    want = jops.sp_filter(*(jnp.asarray(a) for a in o), **kw)
    assert q_new.shape == shape
    np.testing.assert_array_equal(q_new.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-6)


def test_ops_mixed_dtypes_and_zero_d_sums():
    """bf16 q with f32 p, f64 gamma/rho: the plain path takes them as they
    come; the sums stay 0-d float32 tensors (no host sync)."""
    q, p, gamma, rho = _torch(_operands((2, 3, 4, 5), seed=3))
    q_new, gp, err = ops.sp_filter(q.to(torch.bfloat16), p, gamma.double(),
                                   rho.double(), **_kw("symmetric"))
    assert q_new.dtype == torch.bfloat16 and q_new.shape == (2, 3, 4, 5)
    assert torch.is_tensor(gp) and gp.shape == () and gp.dtype == torch.float32
    assert torch.is_tensor(err) and err.shape == ()


def test_kernel_binding_takes_cuda_tensors_only():
    """The binding never runs the plain version in the kernel's place."""
    from repro_torch.kernels.sp_filter import blocks_for, sp_filter_cuda

    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sp_filter_cuda(x, x, torch.ones_like(x), x, **_kw("symmetric"))
    # pass 1's grid depends on the size alone, so the sums' order does too
    assert [blocks_for(n) for n in (0, 1, 256, 257, 10 ** 8)] == \
        [1, 1, 1, 2, 132 * 8]

