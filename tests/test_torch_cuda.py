"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports no JAX (the other ``test_torch_*`` files hold the plain
versions to the JAX package on the CPU), so it runs on a machine that has
the card and PyTorch alone:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

* K1 ``ops.analog_update``: bit-equal to the plain version.
* K3 ``ops.analog_mvm``: within one ADC step (``out_res * s`` of the row,
  plus the rounding of the output to its dtype: four float32 ULPs or one
  bfloat16 ULP of the value) and at least 99.9 % bit-equal; the plain
  version's cuBLAS product sums in another order, which can move y across
  an ADC rounding boundary. Its DAC prologue's codes and row scale are
  bit-equal to ``ref.dac_codes``.
* K2 ``ops.sp_filter``: ``q_new`` bit-equal, the sums within ``rtol=1e-5``
  and bit-identical from run to run.
Each wrapper call launches its kernel once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see README)")


def _card(arrays, dtypes):
    """numpy arrays -> tensors on the card, each cast to its dtype name."""
    return [torch.from_numpy(a).cuda().to(TDT[d]) for a, d in zip(arrays, dtypes)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (300, 700), (4, 300, 700)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analog_update_kernel_matches_plain(cuda, shape, dtype):
    kw = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1, bl=10)
    rng = np.random.default_rng(0)
    w, dw, gamma, rho, zeta = _card(
        [rng.uniform(-0.8, 0.8, shape).astype(np.float32),
         (0.05 * rng.standard_normal(shape)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.3 * rng.standard_normal(shape)).astype(np.float32),
         rng.standard_normal(shape).astype(np.float32)],
        [dtype, dtype, "float32", "float32", "float32"])
    ubits = torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        .astype(np.int64)).cuda()
    before = ops.LAUNCHES["analog_update"]
    got = ops.analog_update(w, dw, gamma, rho, None, noise=(ubits, zeta), **kw)
    assert ops.backend(w) == "cuda"
    assert ops.LAUNCHES["analog_update"] == before + 1
    want = ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


IO = dict(inp_res=1 / 126, inp_bound=1.0, out_res=1 / 510, out_bound=12.0,
          out_noise=0.06)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 784), (33, 47), (5, 1), (2048, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dac_codes_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.analog_matmul import dac_codes_cuda

    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    x[1 % shape[0]] = 0.0  # a zero row: s is the 1e-12 floor
    (x,) = _card([x], [dtype])
    codes, s = dac_codes_cuda(x, inp_res=IO["inp_res"],
                              inp_bound=IO["inp_bound"])
    want_codes, want_s = ref.dac_codes(x, IO["inp_res"], IO["inp_bound"])
    torch.cuda.synchronize()
    assert codes.dtype == torch.bfloat16 and codes.shape == x.shape
    assert torch.equal(s, want_s)
    assert torch.equal(codes.float(), want_codes)


# the reference tests' products, ragged K (1, 47), M not a multiple of 16,
# and shapes that take each of the kernel's three tile sizes
@pytest.mark.cuda
@pytest.mark.parametrize("xshape,wshape", [((64, 128), (128, 96)),
                                           ((5, 33, 47), (47, 29)),
                                           ((17, 1), (1, 40)),
                                           ((37, 200), (200, 130)),
                                           ((64, 784), (784, 256)),
                                           ((512, 896), (896, 1024)),
                                           ((1024, 256), (256, 1024)),
                                           ((2048, 96), (96, 1536))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "f32x-bf16w"])
def test_analog_mvm_kernel_matches_plain(cuda, xshape, wshape, dtype):
    xd, wd = (("float32", "bfloat16") if dtype == "f32x-bf16w"
              else (dtype, dtype))
    rng = np.random.default_rng(1)
    x, w = _card([rng.standard_normal(xshape).astype(np.float32),
                  (0.1 * rng.standard_normal(wshape)).astype(np.float32)],
                 [xd, wd])
    dtype = xd
    m, n = x.numel() // xshape[-1], wshape[1]
    noise = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).cuda()
    before = ops.LAUNCHES["analog_mvm"]
    got = ops.analog_mvm(x, w, None, noise=noise, **IO)
    assert ops.LAUNCHES["analog_mvm"] == before + 1
    assert got.dtype == x.dtype and tuple(got.shape) == (*xshape[:-1], n)
    x2 = x.reshape(m, -1)
    want = ref.analog_mvm_ref(x2, w, noise, **IO)
    torch.cuda.synchronize()
    got, want = got.reshape(m, n).float(), want.float()
    tol = IO["out_res"] * ref.abs_max_scale(x2) + want.abs() * (
        2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -21)
    assert bool(((got - want).abs() <= tol).all())
    assert (got == want).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_analog_mvm_kernel_refuses_codes_bfloat16_cannot_hold(cuda):
    from repro_torch.kernels.analog_matmul import analog_mvm_cuda

    x, w, noise = (torch.zeros(4, 8, device="cuda"),
                   torch.zeros(8, 3, device="cuda"),
                   torch.zeros(4, 3, device="cuda"))
    with pytest.raises(ValueError, match="exact in bfloat16"):
        analog_mvm_cuda(x, w, noise, **dict(IO, inp_res=1 / 512))
    before = ops.LAUNCHES["analog_mvm"]
    with pytest.raises(ValueError, match="exact in bfloat16"):
        ops.analog_mvm(x, w, None, noise=noise, **dict(IO, inp_bound=3.0))
    assert ops.LAUNCHES["analog_mvm"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 97), (3, 33, 97), (784, 256),
                                   (896, 4864)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_filter_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(2)
    q, p, gamma, rho = _card(
        [(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.2 * rng.standard_normal(shape)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.3 * rng.standard_normal(shape)).astype(np.float32)],
        [dtype, dtype, "float32", "float32"])
    kw = dict(eta=0.3, tau_min=0.7, tau_max=1.3)
    before = ops.LAUNCHES["sp_filter"]
    q_new, gp, err = ops.sp_filter(q, p, gamma, rho, **kw)
    again = ops.sp_filter(q, p, gamma, rho, **kw)
    assert ops.LAUNCHES["sp_filter"] == before + 2
    want = ref.sp_filter_ref(q, p, gamma, rho, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q_new, want[0])
    assert torch.equal(gp, again[1]) and torch.equal(err, again[2])
    torch.testing.assert_close(gp, want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(err, want[2], rtol=1e-5, atol=0)
