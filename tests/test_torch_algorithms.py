"""The port's seven analog algorithms against the JAX package, and the
port's batched update against its own per-member loop.

One ``begin_step`` + ``update`` per algorithm, from a tile initialized by
the JAX package and carried across with ``repro_torch.convert``, with the
same keys on both sides. Tolerances: state ``rtol=1e-6, atol=1e-7`` (the
c2c noise goes through threefry normals that agree to a few ULP; pulse
counts are exact), metrics ``rtol=1e-5`` (means sum in another order).
The fused/batched backend must be bit-identical to the per-member loop
under ``rng='hash'``, as the JAX package's tile-engine test requires.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import device as jdev  # noqa: E402
from repro.core import tile as jtile  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import device, tile  # noqa: E402
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig  # noqa: E402
from repro_torch.core.trainer import AnalogTrainer, TrainerConfig  # noqa: E402

ALGOS = ("sgd", "ttv1", "ttv2", "agad", "residual", "rider", "erider")
HP = dict(lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.3, chopper_p=0.5,
          transfer_every=2)
DEV = dict(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.1,
           ref_mean=0.2, ref_std=0.1)


def _cfgs(algorithm, **extra):
    j = jtile.TileConfig(algorithm=algorithm, device_p=jdev.DeviceConfig(**DEV),
                         device_w=jdev.DeviceConfig(**DEV), **HP, **extra)
    t = tile.TileConfig(algorithm=algorithm, device_p=device.DeviceConfig(**DEV),
                        device_w=device.DeviceConfig(**DEV), **HP, **extra)
    return j, t


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _tkey(jkey):
    return prng.wrap_key_data(np.asarray(jkey))


def _assert_state(got, want):
    for k, v in want.items():
        g = got[k]
        if v is None:
            assert g is None, k
        elif isinstance(v, dict):
            _assert_state(g, v)
        else:
            np.testing.assert_allclose(convert.to_numpy(g), np.asarray(v),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


CASES = [(a, {}) for a in ALGOS] + [
    ("erider", dict(buffered_transfer=True, grad_norm="absmean")),
    ("rider", dict(store_device=False, rng="hash")),
    ("ttv2", dict(bl=2, metrics="pulses")),
]


@pytest.mark.parametrize("algorithm,extra", CASES,
                         ids=[a + ("-" + "-".join(e) if e else "")
                              for a, e in CASES])
def test_begin_step_and_update_match_jax(algorithm, extra):
    jcfg, tcfg = _cfgs(algorithm, **extra)
    rng = np.random.default_rng(0)
    w0 = (0.1 * rng.standard_normal((16, 24))).astype(np.float32)
    sp = (0.2 * rng.standard_normal((16, 24))).astype(np.float32)
    grad = rng.standard_normal((16, 24)).astype(np.float32)
    k_init, k_begin, k_upd = jax.random.split(jax.random.PRNGKey(11), 3)
    jst = jtile.init_tile(k_init, jnp.asarray(w0), jcfg,
                          jnp.asarray(sp) if algorithm == "residual" else None)
    tst = convert.tile_state(_np_tree(dict(jst)), "cpu")
    lr = 0.1
    for step in range(2):  # two steps: exercise t % transfer_every
        kb, ku = jax.random.fold_in(k_begin, step), jax.random.fold_in(k_upd, step)
        jst = jalg.begin_step(jst, kb, jcfg)
        tst = alg.begin_step(tst, _tkey(kb), tcfg)
        _assert_state(tst, jst)
        jst, jm = jalg.update(jst, jnp.asarray(grad), ku, jcfg, jnp.float32(lr))
        tst, tm = alg.update(tst, torch.from_numpy(grad), _tkey(ku), tcfg,
                             torch.tensor(lr, dtype=torch.float32))
        _assert_state(tst, jst)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    want = jalg.effective_weight(jst, jcfg)
    got = alg.effective_weight(tst, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("algorithm", ["erider", "rider", "ttv2", "agad", "sgd"])
def test_update_batched_bit_identical_to_member_loop(algorithm):
    _, tcfg = _cfgs(algorithm, rng="hash")
    tcfg_f = _cfgs(algorithm, rng="hash", update_backend="fused")[1]
    members = [tile.init_tile(prng.fold_in(prng.PRNGKey(0), i),
                              0.1 * torch.ones(8, 12), tcfg) for i in range(3)]
    stack = tile.stack_tiles({f"p{i}": m for i, m in enumerate(members)},
                             [("g", ("p0", "p1", "p2"))]).groups["g"]
    grad = torch.randn(3, 8, 12, generator=torch.Generator().manual_seed(0))
    keys = prng.split(prng.PRNGKey(5), 3)
    lr = torch.tensor(0.1)
    got, gm = alg.update_batched(stack, grad, keys, tcfg_f, lr)
    for i, m in enumerate(members):
        want, wm = alg.update(m, grad[i], keys[i], tcfg, lr)
        for k, v in want.items():
            if v is None:
                assert got[k] is None
            elif isinstance(v, dict):
                for kk in v:
                    assert torch.equal(got[k][kk][i], v[kk]), (k, kk)
            else:
                assert torch.equal(got[k][i], v), k
        for k in wm:
            torch.testing.assert_close(gm[k][i], wm[k], rtol=1e-6, atol=0)


def test_fused_backend_bit_identical_to_vmap_hash_in_trainer():
    """Replay of the JAX package's tile-engine acceptance test: a 2-group
    (nM + Mn) class plus an odd singleton, 5 steps, fused vs vmap with
    rng='hash'; tile state bit-identical, metrics to rtol=1e-6."""
    def run(backend):
        dev = device.DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1,
                                  sigma_c2c=0.05)
        cfg = TrainerConfig(
            tile=tile.TileConfig(algorithm="erider", device_p=dev,
                                 device_w=dev, lr_p=0.5, lr_w=0.5, gamma=0.1,
                                 eta=0.1, chopper_p=0.1, rng="hash",
                                 update_backend=backend),
            digital=DigitalOptConfig(kind="sgd"),
            schedule=ScheduleConfig(kind="constant", base_lr=0.1))

        def loss_fn(params, batch, rng):
            return sum(torch.sum(v ** 2) for _, v in sorted(params.items())), {}

        tr = AnalogTrainer(loss_fn, cfg, analog_filter=lambda p, l: True)
        params = {}
        for i in range(3):
            params[f"l{i}/attn/wq"] = 0.1 * torch.ones(8, 8)
            params[f"l{i}/attn/wo"] = 0.1 * torch.ones(8, 8)
        params["odd"] = 0.1 * torch.ones(4, 24)
        state = tr.init(prng.PRNGKey(7), params)
        for _ in range(5):
            state, m = tr.train_step(state, None)
        return state, m

    s_f, m_f = run("fused")
    s_v, m_v = run("vmap")
    assert set(s_f["tiles"].classes) == set(s_v["tiles"].classes)
    assert len(s_f["tiles"].classes) == 2
    for c in s_f["tiles"].classes:
        a, b = convert.to_numpy(s_f["tiles"].classes[c]), \
            convert.to_numpy(s_v["tiles"].classes[c])
        for k in b:
            if isinstance(b[k], dict):
                for kk in b[k]:
                    np.testing.assert_array_equal(a[k][kk], b[k][kk])
            elif b[k] is not None:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert set(m_f) == set(m_v)
    for k in m_f:
        torch.testing.assert_close(m_f[k], m_v[k], rtol=1e-6, atol=0)
