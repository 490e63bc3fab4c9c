"""The port's RNG against JAX's: threefry keys and draws (``repro_torch.prng``)
and the fastrng hash (``repro_torch.kernels.fastrng``).

Tolerances: integer bits are bit-exact; uniforms and bernoulli draws are
bit-exact (the port emulates XLA-CPU's fused multiply-add in the scaling);
normals are within 4 float32 ULP (XLA-CPU's ``log1p``/``sqrt`` differ from
torch's by up to 2 ULP on some inputs).

In a fresh process that has imported the port, the first multi-threaded
call of each CPU math kernel the draws use returns the same values as the
next one (``repro_torch._init_cpu_vector_math``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fastrng as jrng  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.kernels import fastrng  # noqa: E402

SHAPES = [(7,), (33, 97), (3, 5, 7)]


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _tkey(jkey):
    return prng.wrap_key_data(np.array(jax.random.key_data(jkey)))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_prngkey_split_fold_in_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.split(jk, 5)),
                                  prng.split(tk, 5).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, 123456789)),
                                  prng.fold_in(tk, 123456789).numpy())
    # a batch of keys splits row by row, as vmap(split) does
    keys = jax.random.split(jk, 4)
    want = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    np.testing.assert_array_equal(np.asarray(want),
                                  prng.split(_tkey(keys), 3).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bit_exact(shape):
    jk = jax.random.PRNGKey(3)
    tk = _tkey(jk)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(want, prng.bits(tk, shape, "cpu").numpy())
    for lo, hi in ((0.0, 1.0), (-0.8, 0.8)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(
            want, prng.uniform(tk, shape, lo, hi, "cpu").numpy())


def test_bernoulli_bit_exact():
    keys = jax.random.split(jax.random.PRNGKey(9), 64)
    for p in (0.05, 0.1, 0.5):
        want = [bool(jax.random.bernoulli(k, p)) for k in keys]
        got = [bool(prng.bernoulli(_tkey(k), p)) for k in keys]
        assert want == got, p


@pytest.mark.parametrize("shape", [(1000,), (3, 33, 97)])
def test_normal_within_4ulp(shape):
    jk = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(jk, shape))
    got = prng.normal(_tkey(jk), shape, "cpu").numpy()
    assert _ulp(want, got).max() <= 4


def test_truncated_normal_within_4ulp():
    jk = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.truncated_normal(jk, -2, 2, (784, 256),
                                                  jnp.float32))
    got = prng.truncated_normal(_tkey(jk), -2, 2, (784, 256), "cpu").numpy()
    assert _ulp(want, got).max() <= 4


@pytest.mark.parametrize("shape", SHAPES + [(512, 1024)])
def test_hash_bits_bit_exact(shape):
    seed = np.array([123, 4567890], np.uint32)
    for salt in (1, 2, 11):
        want = np.asarray(jrng.hash_bits(jnp.asarray(seed), shape, salt))
        got = fastrng.hash_bits(torch.tensor(seed.astype(np.int64)), shape,
                                salt, "cpu").numpy()
        np.testing.assert_array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("shape", [(3, 33, 97), (512, 1024)])
def test_hash_normal_within_4ulp(shape):
    seed = np.array([7, 99], np.uint32)
    want = np.asarray(jrng.hash_normal(jnp.asarray(seed), shape, 2))
    got = fastrng.hash_normal(torch.tensor(seed.astype(np.int64)), shape, 2,
                              "cpu").numpy()
    assert _ulp(want, got).max() <= 4
    want_u = np.asarray(jrng.hash_uniform(jnp.asarray(seed), shape, 1))
    got_u = fastrng.hash_uniform(torch.tensor(seed.astype(np.int64)), shape,
                                 1, "cpu").numpy()
    np.testing.assert_array_equal(want_u, got_u)


def test_hash_seed_batch_rows_are_single_draws():
    seeds = torch.tensor([[1, 2], [3, 4], [2 ** 32 - 1, 5]])
    bits = fastrng.hash_bits(seeds, (4, 5), 1, "cpu")
    normals = fastrng.hash_normal(seeds, (4, 5), 2, "cpu")
    for i in range(3):
        assert torch.equal(bits[i], fastrng.hash_bits(seeds[i], (4, 5), 1, "cpu"))
        assert torch.equal(normals[i],
                           fastrng.hash_normal(seeds[i], (4, 5), 2, "cpu"))


def test_hash_normal_finite_at_lattice_edges(monkeypatch):
    """Replay of the JAX package's test: the inverse-CDF transform stays
    finite at the ends of the uint32 lattice."""
    edge = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1])
    monkeypatch.setattr(fastrng, "hash_bits",
                        lambda seed, shape, salt, device="cuda": edge)
    z = fastrng.hash_normal(torch.zeros(2, dtype=torch.int64), edge.shape, 0,
                            "cpu").numpy()
    assert np.all(np.isfinite(z)), z
    assert np.all(np.abs(z) < 6.0), z
    np.testing.assert_allclose(z[0], -z[-1], rtol=1e-5)
    assert z[0] < -3.0 and z[-1] > 3.0, z


def test_hash_normal_matches_exact_inverse_cdf(monkeypatch):
    """Replay of the JAX package's test: the fast erfinv tracks the exact
    inverse CDF (here float64 ``torch.special.erfinv``)."""
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, size=1 << 16,
                                         dtype=np.uint32).astype(np.int64))
    monkeypatch.setattr(fastrng, "hash_bits",
                        lambda seed, shape, salt, device="cuda": bits)
    got = fastrng.hash_normal(torch.zeros(2, dtype=torch.int64), bits.shape,
                              0, "cpu").numpy()
    u = (bits.to(torch.float32) + 0.5) * (1.0 / 4294967296.0)
    x = torch.clamp(2.0 * u - 1.0, -fastrng._ONE_MINUS_EPS,
                    fastrng._ONE_MINUS_EPS)
    exact = (fastrng._SQRT2 * torch.special.erfinv(x.double())).numpy()
    err = np.abs(got - exact)
    assert err.mean() < 1e-4, err.mean()
    assert err.max() < 0.02, err.max()


_FIRST_CALL = """
import sys
import repro_torch, torch
g = torch.Generator().manual_seed(0)
w = torch.rand(512, 640, generator=g) * 0.9 + 0.05
op = getattr(torch, sys.argv[1])
first = op(w)
sys.exit(0 if torch.equal(first, op(w)) else 1)
"""
_KERNELS = ("sqrt", "exp", "log", "log1p", "tanh", "sin")


def test_first_threaded_math_call_after_import_is_right():
    """torch's CPU build can return wrong values (on one thread's share of
    the elements) from the first call into MKL's vector math of a process
    when it runs on several threads, in some fresh processes. The port
    makes that first call on one thread when it is imported. Six fresh
    processes, one after the other, each with another kernel first, check
    the result after the import. This is a check, not a guard of the
    warm-up: without it the fault shows in some processes only (the
    threads must meet), so six can all miss it."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    for name in _KERNELS:   # one at a time: the race needs the cores
        out = subprocess.run([sys.executable, "-c", _FIRST_CALL, name],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, (name, out.stderr[-2000:])
