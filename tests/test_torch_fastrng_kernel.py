"""The Hopper form of ``kernels/fastrng.py`` on the CPU: K1's hash-noise
mode (``repro_torch::analog_update_hash`` and its in-place
``::analog_update_hash_``) and the one-pass ``repro_torch::hash_normal``.

* Their CPU implementations (the plain versions) are bit-equal to what the
  port computed before them: the eager ``fastrng`` draws (salts 1 and 2,
  the linear index restarting per member) fed to ``ref.analog_update_ref``
  through K1's operand mode, and the eager ``hash_normal_ref`` chain.
* The same numpy inputs through the JAX package's ``fastrng`` and its
  ``ref.analog_update_ref``: hash bits exact; normals within 4 float32 ULP
  (XLA-CPU's ``sqrt`` on the erfinv tail differs from torch's by one ULP
  on some inputs, as ``test_torch_prng.py`` states); the updated ``w``
  within ``atol=1e-6`` in float32 (the hash-RNG update tests' tolerance:
  the c2c noise term carries the normals' ULPs) and one bfloat16 step
  (``2**-7`` for |w| < 1) in bfloat16.
* On ``meta`` the fake rules give the shapes and dtypes the card would.
* The device parameters of a tile are drawn once per update.
The kernels against their plain versions on the card:
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fastrng as jrng  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import device, tile  # noqa: E402
from repro_torch.kernels import fastrng, ops, ref  # noqa: E402

KW = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (w shape, number of seeds): a 2-D tile with one seed, (n, m, k) stacks
# with one seed per member, a 4-D MoE-shaped (periods, experts, d, f) stack
CASES = [((33, 97), 1), ((3, 33, 97), 3), ((5, 16, 24), 5),
         ((2, 4, 16, 24), 2), ((1, 4, 16, 24), 1)]


def _ulp(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _operands(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.8, 0.8, shape).astype(np.float32)
    dw = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    gamma = np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32)
    rho = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return (torch.from_numpy(w).to(TDT[dtype]), torch.from_numpy(dw),
            torch.from_numpy(gamma), torch.from_numpy(rho))


def _keys(n, seed):
    """``n`` host keys with words past 2**31 (the int32 wrap)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64)
    return torch.from_numpy(k.astype(np.int64))


def _key_arg(keys, n):
    return keys[0] if n == 1 else keys


@pytest.mark.parametrize("shape,n", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bl", [0, 10])
def test_hash_mode_bit_equal_to_operand_mode(shape, n, dtype, bl):
    """The new op (and its in-place form) against the eager draws composed
    with the plain update, through K1's operand mode: bit for bit."""
    w, dw, gamma, rho = _operands(shape, dtype, 3)
    keys = _keys(n, 4)
    key = _key_arg(keys, n)
    seed = fastrng.seed_from_key(key)
    member = shape[1:] if n > 1 else shape
    ubits = fastrng.hash_bits(seed, member, 1, "cpu").reshape(shape)
    zeta = fastrng.hash_normal_ref(seed, member, 2, "cpu").reshape(shape)
    want = ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta, bl=bl, **KW)
    before = dict(ops.LAUNCHES)
    got = ops.analog_update(w, dw, gamma, rho, key, rng="hash", bl=bl, **KW)
    assert got.dtype == w.dtype and got.shape == w.shape
    assert torch.equal(got, want)
    operand = ops.analog_update(w, dw, gamma, rho, None, bl=bl, **KW,
                                noise=ops.make_noise(key, member, "cpu",
                                                     "hash")
                                if n == 1 else (ubits, zeta))
    assert torch.equal(got, operand)
    w2 = w.clone()
    assert ops.analog_update(w2, dw, gamma, rho, key, rng="hash", bl=bl,
                             out=w2, **KW) is w2
    assert torch.equal(w2, want)
    assert ops.LAUNCHES == before  # the plain path launches nothing
    if n > 1:  # member i is the draw of seed i alone
        for i in range(n):
            one = ops.analog_update(w[i], dw[i], gamma[i], rho[i], keys[i],
                                    rng="hash", bl=bl, **KW)
            assert torch.equal(got[i], one)


@pytest.mark.parametrize("shape,n", CASES[:3])
@pytest.mark.parametrize("salt", [2, 11, 13, 17])
def test_hash_normal_op_bit_equal_to_eager_chain(shape, n, salt):
    keys = _keys(n, 5)
    seed = fastrng.seed_from_key(_key_arg(keys, n))
    member = shape[1:] if n > 1 else shape
    got = fastrng.hash_normal(seed, member, salt, "cpu")
    want = fastrng.hash_normal_ref(seed, member, salt, "cpu")
    assert got.shape == shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    # the int32 words the kernels take draw the same numbers
    words = fastrng.device_seeds(seed, "cpu")
    assert words.dtype == torch.int32 and words.shape == seed.shape
    assert torch.equal(fastrng.hash_normal(words, member, salt, "cpu"), want)


@pytest.mark.parametrize("shape,n", [((33, 97), 1), ((3, 33, 97), 3),
                                     ((2, 4, 16, 24), 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_mode_against_jax(shape, n, dtype):
    """The JAX package's fastrng draws per member and its reference update
    on the same numpy inputs."""
    w, dw, gamma, rho = _operands(shape, dtype, 6)
    keys = _keys(n, 7)
    seeds = keys.numpy().astype(np.uint32)
    member = shape[1:] if n > 1 else shape
    jbits = np.stack([np.asarray(jrng.hash_bits(jnp.asarray(s), member, 1))
                      for s in seeds]).reshape(shape)
    jz = np.stack([np.asarray(jrng.hash_normal(jnp.asarray(s), member, 2))
                   for s in seeds]).reshape(shape)
    key = _key_arg(keys, n)
    seed = fastrng.seed_from_key(key)
    np.testing.assert_array_equal(
        fastrng.hash_bits(seed, member, 1, "cpu").reshape(shape).numpy(),
        jbits.astype(np.int64))
    assert _ulp(fastrng.hash_normal(seed, member, 2, "cpu").reshape(
        shape).numpy(), jz).max() <= 4
    jdt = jnp.dtype(dtype)
    want = jref.analog_update_ref(
        jnp.asarray(w.float().numpy(), jdt), jnp.asarray(dw.numpy()),
        jnp.asarray(gamma.numpy()), jnp.asarray(rho.numpy()),
        jnp.asarray(jbits), jnp.asarray(jz), **KW)
    got = ops.analog_update(w, dw, gamma, rho, key, rng="hash", **KW)
    atol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("salt", [2, 11, 13, 17])
def test_hash_normal_against_jax_on_a_stack(salt):
    keys = _keys(3, salt)
    want = np.stack([np.asarray(jrng.hash_normal(
        jnp.asarray(k.astype(np.uint32)), (33, 97), salt))
        for k in keys.numpy()])
    got = fastrng.hash_normal(keys, (33, 97), salt, "cpu").numpy()
    assert _ulp(want, got).max() <= 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_rules_on_meta(dtype):
    meta = torch.device("meta")
    shape = (4, 8, 16, 24)
    w = torch.empty(shape, dtype=TDT[dtype], device=meta)
    f = torch.empty(shape, device=meta)
    keys = _keys(4, 8)
    out = ops.analog_update(w, f, f, f, keys, rng="hash", **KW)
    assert out.device == meta and out.shape == shape
    assert out.dtype == TDT[dtype]
    assert ops.analog_update(w, f, f, f, keys, rng="hash", out=w, **KW) is w
    one = ops.analog_update(w[0], f[0], f[0], f[0], keys[0], rng="hash", **KW)
    assert one.shape == shape[1:] and one.dtype == TDT[dtype]
    z = fastrng.hash_normal(keys, shape[1:], 11, meta)
    assert z.device == meta and z.shape == shape
    assert z.dtype == torch.float32
    assert fastrng.hash_normal(keys[0], (5, 7), 2, meta).shape == (5, 7)


def test_bindings_take_cuda_tensors_only():
    """The kernels' bindings never run the plain version in a kernel's
    place: a CPU tensor is refused."""
    from repro_torch.kernels.analog_update import analog_update_hash_cuda

    x = torch.zeros(4, 4)
    seeds = fastrng.device_seeds(_keys(1, 0)[0], "cpu").reshape(-1, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        analog_update_hash_cuda(x, x, x, x, seeds, **KW)
    with pytest.raises(ValueError, match="int32 CUDA"):
        fastrng.hash_normal_cuda(seeds, x, 2)


def test_device_seeds_wrap_to_int32_words():
    s = torch.tensor([[2 ** 32 - 1, 5], [2 ** 31, 2 ** 31 - 1]])
    got = fastrng.device_seeds(s, "cpu")
    assert got.dtype == torch.int32
    assert got.tolist() == [[-1, 5], [-2 ** 31, 2 ** 31 - 1]]
    assert fastrng.device_seeds(got, "cpu") is got


def _seeded_tile(shape, n=0):
    dev = device.DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1,
                              sigma_c2c=0.1, ref_mean=0.2, ref_std=0.1)
    cfg = tile.TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                          lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.3,
                          store_device=False, rng="hash", metrics="full",
                          update_backend="fused" if n else "vmap")
    inits = [tile.init_tile(prng.fold_in(prng.PRNGKey(1), i),
                            0.1 * torch.ones(shape), cfg)
             for i in range(max(n, 1))]
    if not n:
        return cfg, inits[0]
    names = tuple(f"p{i}" for i in range(n))
    return cfg, tile.stack_tiles(dict(zip(names, inits)),
                                 [("g", names)]).groups["g"]


@pytest.mark.parametrize("batched", [False, True])
def test_device_parameters_drawn_once_per_update(monkeypatch, batched):
    """P's gamma/rho serve the P write and the metrics from one draw: two
    ``sample_device`` calls an update (W and P), not three."""
    cfg, st = _seeded_tile((8, 12), 3 if batched else 0)
    calls = []
    real = alg.sample_device

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(alg, "sample_device", counting)
    lr = torch.tensor(0.1)
    if batched:
        grad = torch.randn(3, 8, 12,
                           generator=torch.Generator().manual_seed(0))
        _, m = alg.update_batched(st, grad, prng.split(prng.PRNGKey(2), 3),
                                  cfg, lr)
    else:
        grad = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
        _, m = alg.update(st, grad, prng.PRNGKey(2), cfg, lr)
    assert {"gp_sq", "sp_err", "pulses"} <= set(m)
    assert len(calls) == 2
