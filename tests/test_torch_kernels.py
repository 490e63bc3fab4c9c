"""The port's pulse-update kernel path against the JAX package.

* ``kernels.ref.analog_update_ref`` (the plain version of the CUDA kernel)
  against JAX ``ref.analog_update_ref``: bit-exact (both divide, op by op)
  in float32 and bfloat16; against the Pallas kernel in interpret mode:
  ``atol=1e-6`` (f32) / ``1e-2`` (bf16), the reference's own tolerance,
  because the Pallas body multiplies by reciprocals.
* ``kernels.ops.analog_update`` against JAX ``ops.analog_update`` on ragged
  shapes under both RNG modes: ``atol=1e-6`` (threefry normals agree to a
  few ULP, so the c2c noise term does too; pulse counts are exact).
* The CUDA kernel against the plain version: needs a card, skips here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.analog_update import analog_update_pallas  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

KW = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1, bl=10)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(shape, dtype="float32", seed=0):
    """numpy operands from a seed; w/dw rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.8, 0.8, shape).astype(np.float32)
    dw = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
        dw = np.array(jnp.asarray(dw, jnp.bfloat16).astype(jnp.float32))
    gamma = np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32)
    rho = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    ubits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    zeta = rng.standard_normal(shape).astype(np.float32)
    return w, dw, gamma, rho, ubits, zeta


def _jax(ops_np, dtype):
    w, dw, gamma, rho, ubits, zeta = ops_np
    dt = jnp.dtype(dtype)
    return (jnp.asarray(w, dt), jnp.asarray(dw, dt), jnp.asarray(gamma),
            jnp.asarray(rho), jnp.asarray(ubits), jnp.asarray(zeta))


def _torch(ops_np, dtype):
    w, dw, gamma, rho, ubits, zeta = ops_np
    dt = TDT[dtype]
    return (torch.from_numpy(w).to(dt), torch.from_numpy(dw).to(dt),
            torch.from_numpy(gamma), torch.from_numpy(rho),
            torch.from_numpy(ubits.astype(np.int64)), torch.from_numpy(zeta))


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(8, 128), (256, 512), (300, 700), (512, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analog_update_ref_matches_jax_ref_and_pallas(shape, dtype):
    o = _operands(shape, dtype)
    got = ref.analog_update_ref(*_torch(o, dtype), **KW)
    assert got.dtype == TDT[dtype]
    want = jref.analog_update_ref(*_jax(o, dtype), **KW)
    np.testing.assert_array_equal(_f32(got), _f32(want))

    m, n = shape
    bm, bn = min(256, m), min(512, n)

    def pad(x, fill=0.0):
        return jnp.pad(x, ((0, (-m) % bm), (0, (-n) % bn)), constant_values=fill)

    w, dw, gamma, rho, ubits, zeta = _jax(o, dtype)
    pallas = analog_update_pallas(
        pad(w), pad(dw), pad(gamma, 1.0), pad(rho),
        pad(ubits, jnp.uint32(1 << 31)), pad(zeta), block=(bm, bn),
        interpret=True, **KW)[:m, :n]
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol)


def test_int32_bit_pattern_ubits_match_int64():
    """The kernel takes ubits as an int32 bit pattern; the plain version
    reads both forms the same."""
    o = _torch(_operands((33, 97)), "float32")
    as_i32 = o[4].to(torch.int32)
    a = ref.analog_update_ref(*o, **KW)
    b = ref.analog_update_ref(*o[:4], as_i32, o[5], **KW)
    assert torch.equal(a, b)


def test_expected_ref_matches_jax():
    w, dw, gamma, rho, _, _ = _operands((64, 96), seed=3)
    got = ref.analog_update_expected_ref(
        torch.from_numpy(w), torch.from_numpy(dw), torch.from_numpy(gamma),
        torch.from_numpy(rho), tau_min=1.0, tau_max=1.0)
    want = jref.analog_update_expected_ref(
        jnp.asarray(w), jnp.asarray(dw), jnp.asarray(gamma), jnp.asarray(rho),
        tau_min=1.0, tau_max=1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(33, 97), (3, 33, 97)])
@pytest.mark.parametrize("rng", ["threefry", "hash"])
def test_ops_matches_jax_ops_on_ragged_shapes(shape, rng):
    w, dw, gamma, rho, _, _ = _operands(shape, seed=1)
    jkey = jax.random.PRNGKey(0)
    want = jops.analog_update(jnp.asarray(w), jnp.asarray(dw),
                              jnp.asarray(gamma), jnp.asarray(rho), jkey,
                              rng=rng, **KW)
    got = ops.analog_update(torch.from_numpy(w), torch.from_numpy(dw),
                            torch.from_numpy(gamma), torch.from_numpy(rho),
                            prng.wrap_key_data(np.asarray(jkey)), rng=rng, **KW)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ops_arbitrary_rank_and_noise_operands():
    """Any rank goes through; pre-drawn noise replaces key and rng."""
    for shape in [(50,), (2, 3, 4, 5)]:
        w = torch.zeros(shape)
        out = ops.analog_update(w, 0.01 * torch.ones(shape), torch.ones(shape),
                                torch.zeros(shape), prng.PRNGKey(0), dw_min=0.01,
                                tau_min=1.0, tau_max=1.0, sigma_c2c=0.0)
        assert out.shape == shape
        torch.testing.assert_close(out, torch.full(shape, 0.01))
    o = _torch(_operands((3, 8, 16)), "float32")
    got = ops.analog_update(*o[:4], None, noise=(o[4], o[5]), **KW)
    assert torch.equal(got, ref.analog_update_ref(*o, **KW))


def test_backend_follows_the_tensor_and_never_falls_back():
    x = torch.zeros(4, 4)
    assert ops.backend(x) == "ref"
    before = dict(ops.LAUNCHES)
    ops.analog_update(x, x, torch.ones_like(x), x, prng.PRNGKey(0), **KW)
    assert ops.LAUNCHES == before  # the plain path launches nothing
    # the kernel's binding takes CUDA tensors only; it never runs the plain
    # version in the kernel's place
    from repro_torch.kernels.analog_update import analog_update_cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        analog_update_cuda(x, x, torch.ones_like(x), x, x.to(torch.int32), x,
                           **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (300, 700), (4, 300, 700)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_on_card(shape, dtype):
    """On the card: the CUDA kernel is bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see README)")
    o = [t.cuda() for t in _torch(_operands(shape, dtype), dtype)]
    before = ops.LAUNCHES["analog_update"]
    got = ops.analog_update(*o[:4], None, noise=(o[4], o[5]), **KW)
    assert ops.backend(o[0]) == "cuda"
    assert ops.LAUNCHES["analog_update"] == before + 1
    want = ref.analog_update_ref(*o, **KW)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
