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
* ``ref.dac_codes`` (the integer codes the CUDA prologue writes) against
  the reference's DAC: ``codes * inp_res`` and the row scale bit-exact.
* ``ref.split_bf16`` (the CUDA kernel's three bfloat16 pieces of an f32
  ``w``): their sum is ``w`` exactly, at random values and at the edges.
* An emulation of the CUDA kernel's arithmetic on the CPU (codes times the
  pieces in float32, BK-step partial sums, ``* inp_res``, then the
  epilogue) against JAX ``ref.analog_mvm_ref``: the one-step tolerance
  above.
* The CUDA kernels against the plain version, on the card:
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
    from repro_torch.kernels.analog_matmul import (analog_mvm_cuda,
                                                   dac_codes_cuda,
                                                   mvm_codes_cuda)

    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        analog_mvm_cuda(x, w, torch.zeros(4, 3), **IO)
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        analog_mvm_cuda(x, torch.zeros(7, 3), torch.zeros(4, 3), **IO)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dac_codes_cuda(x, inp_res=IO["inp_res"], inp_bound=IO["inp_bound"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        mvm_codes_cuda(x.to(torch.bfloat16), torch.ones(4, 1), w,
                       torch.zeros(4, 3), torch.float32, inp_res=IO["inp_res"],
                       out_res=IO["out_res"], out_bound=IO["out_bound"],
                       out_noise=IO["out_noise"])


@pytest.mark.parametrize("inp", [(1 / 300, 1.0), (1 / 128, 3.0)])
def test_kernel_binding_refuses_codes_bfloat16_cannot_hold(inp):
    """Codes above 256 would not be exact in bfloat16: the binding raises
    before it looks at the tensors."""
    from repro_torch.kernels.analog_matmul import (analog_mvm_cuda,
                                                   dac_codes_cuda)

    io = dict(IO, inp_res=inp[0], inp_bound=inp[1])
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="exact in bfloat16"):
        analog_mvm_cuda(x, w, torch.zeros(4, 3), **io)
    with pytest.raises(ValueError, match="exact in bfloat16"):
        dac_codes_cuda(x, inp_res=inp[0], inp_bound=inp[1])


def _jax_dac(x, inp_res, inp_bound):
    """The reference's ABS_MAX scale and quantized input (its
    ``analog_mvm_ref`` up to the product)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12)
    xq = jnp.clip(xf / s, -inp_bound, inp_bound)
    return np.asarray(s), np.asarray(jnp.round(xq * (1.0 / inp_res)) * inp_res)


@pytest.mark.parametrize("shape", [(64, 784), (33, 47), (5, 1)])
@pytest.mark.parametrize("inp", [(1 / 126, 1.0), (1 / 62, 0.5), (1 / 256, 1.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dac_codes_match_jax(shape, inp, dtype):
    inp_res, inp_bound = inp
    rng = np.random.default_rng(11)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    x[0, 0] = 0.0
    if shape[1] > 2:
        x[1 % shape[0], :] = 0.0  # an all-zero row: s is the 1e-12 floor
    xt = torch.from_numpy(x).to(TDT[dtype])
    codes, s = ref.dac_codes(xt, inp_res, inp_bound)
    js, jq = _jax_dac(jnp.asarray(x, dtype), inp_res, inp_bound)
    assert codes.dtype == torch.float32 and tuple(s.shape) == (shape[0], 1)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal((codes * inp_res).numpy(), jq)
    # integers the prologue's bfloat16 holds exactly
    assert torch.equal(codes, torch.round(codes))
    assert codes.abs().max().item() <= round(inp_bound / inp_res) <= 256
    assert torch.equal(codes.to(torch.bfloat16).float(), codes)


def _sum64(pieces):
    return sum(p.double() for p in pieces)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_bf16_pieces_sum_to_w(seed):
    """Random float32 over the whole exponent range down to 2**-110, where
    the split is exact: hi + mid + lo == w (summed in float64, since
    hi + mid can round past float32's largest value)."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, 100_000)
    exp = rng.integers(-110, 128, 100_000)
    sign = rng.choice([-1.0, 1.0], 100_000)
    w = torch.from_numpy((sign * np.ldexp(mant, exp)).astype(np.float32))
    pieces = ref.split_bf16(w)
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    assert torch.equal(_sum64(pieces), w.double())
    # the kernel sums them in float32, lo and mid first; that is exact too
    # below 2**126
    small = w.abs() < 2.0 ** 126
    hi, mid, lo = (p.float() for p in pieces)
    assert torch.equal(((lo + mid) + hi)[small], w[small])


def test_split_bf16_pieces_at_the_edges():
    f32max = np.finfo(np.float32).max
    tiny = np.finfo(np.float32).tiny  # 2**-126, the f32 normal minimum
    edges = np.array([0.0, -0.0, f32max, -f32max, 3.3e38, -1e38, 2.0 ** 127,
                      1.0, -0.5, 2.0 ** -110, -(2.0 ** -110) * 1.9999999],
                     np.float32)
    w = torch.from_numpy(edges)
    assert torch.equal(_sum64(ref.split_bf16(w)), w.double())
    assert torch.equal(torch.signbit(ref.split_bf16(w)[0].float()),
                       torch.signbit(w))
    # bfloat16-exact values, near the normal minimum too: hi alone
    rng = np.random.default_rng(5)
    b = torch.from_numpy(np.concatenate([
        rng.standard_normal(1000), tiny * rng.uniform(-4, 4, 1000),
        tiny * np.arange(-128, 129) / 128]).astype(np.float32)
    ).to(torch.bfloat16).float()
    hi, mid, lo = ref.split_bf16(b)
    assert torch.equal(hi.float(), b)
    assert not mid.float().any() and not lo.float().any()
    # float32 values near the normal minimum: bfloat16 cannot hold their
    # lowest bits, so the sum is exact on multiples of bfloat16's subnormal
    # step 2**-133 and within half of it elsewhere
    t = torch.from_numpy((tiny * rng.uniform(-8, 8, 10_000)).astype(np.float32))
    err = (_sum64(ref.split_bf16(t)) - t.double()).abs()
    assert err.max().item() <= 2.0 ** -134
    on_step = torch.from_numpy(np.ldexp(
        rng.integers(-2 ** 16, 2 ** 16, 10_000), -133).astype(np.float32))
    assert torch.equal(_sum64(ref.split_bf16(on_step)), on_step.double())


def _emulate_kernel(x, w, noise, bk=32):
    """The CUDA kernel's arithmetic on the CPU: the prologue's codes, then
    each BK step's partial sum of codes times the bfloat16 pieces of w
    (lo, mid, hi; a bfloat16 w is its own piece) in float32, added into the
    running sum; then ``* inp_res`` and the plain version's epilogue."""
    codes, s = ref.dac_codes(x, IO["inp_res"], IO["inp_bound"])
    pieces = ((w.float(),) if w.dtype == torch.bfloat16
              else tuple(p.float() for p in ref.split_bf16(w)[::-1]))
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], bk):
        c = codes[:, k0:k0 + bk]
        part = torch.zeros_like(acc)
        for p in pieces:
            part = part + c @ p[k0:k0 + bk]
        acc = acc + part
    y = acc * IO["inp_res"] + IO["out_noise"] * noise
    y = torch.clamp(y, -IO["out_bound"], IO["out_bound"])
    y = torch.round(y * (1.0 / IO["out_res"])) * IO["out_res"]
    return (y * s).to(x.dtype)


@pytest.mark.parametrize("mkn", [(64, 784, 256), (512, 896, 1024),
                                 (33, 47, 29), (17, 1, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "f32x-bf16w"])
def test_kernel_arithmetic_matches_jax_ref(mkn, dtype):
    xd, wd = (("float32", "bfloat16") if dtype == "f32x-bf16w"
              else (dtype, dtype))
    x, w, noise = _operands(*mkn, "bfloat16" if dtype != "float32"
                            else "float32", seed=6)
    got = _emulate_kernel(torch.from_numpy(x).to(TDT[xd]),
                          torch.from_numpy(w).to(TDT[wd]),
                          torch.from_numpy(noise))
    assert got.dtype == TDT[xd]
    want = jref.analog_mvm_ref(jnp.asarray(x, xd), jnp.asarray(w, wd),
                               jnp.asarray(noise), **IO)
    _assert_one_step(_f32(got), _f32(want), _scale(x), xd)

