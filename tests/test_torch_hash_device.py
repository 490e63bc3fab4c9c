"""The Hopper form of ``core/device.py``'s hash draw on the CPU: the op
``repro_torch::hash_device`` (``sample_device(method="hash")``) and its
plain version ``fastrng.hash_device_ref`` (the eager chain, on
``kernels/ref.py``'s ``device_params_ref``, which the threefry branch
shares).

* The plain version against the JAX package's
  ``sample_device(method="hash")`` on the same keys, for the training
  CLI's two devices (``launch/train.py``'s ``dev_w`` and ``dev_p``), a
  config without ``sigma_d2d`` and one without ``sigma_d2d`` with a
  target SP, one key for the tile and a batch of 3 (member i as key i
  alone). Without ``sigma_d2d`` (no ``exp``) bit-equal. With it, rule 4's
  gap of XLA-CPU's ``exp`` against torch's, within 4 float32 ULP on at
  most 5 % of the elements; measured at these shapes: gamma 1 ULP on 130
  of 3201 / 425 of 9603 elements, ``dev_p``'s rho (which carries gamma)
  2 ULP at most on 116 / 363, ``dev_w``'s rho bit-equal.
* The op on the CPU, the plain version and the chain ``sample_device``
  ran before the op (three ``hash_normal`` draws, salts 11, 13 and 17,
  then the eager float math) agree bit for bit; the plain version draws
  only the normals its config reads.
* On ``meta`` the fake rule gives both outputs' shapes and dtypes.
* A training step with drawn devices (``store_device=False``, hash noise)
  reaches the op once per device draw under both update backends, and
  ``hash_normal`` not at all.

The kernel against its plain version on the card:
``tests/test_torch_cuda.py`` (``-k hash_device``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import device as jdev  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import device  # noqa: E402
from repro_torch.kernels import fastrng, ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.roofline.op_cost import OpTrace  # noqa: E402

META = torch.device("meta")
# launch/train.py's make_tile_cfg (the full-size CLI's hash tiles): W's
# device and P's, whose rho realizes a target SP
DEV_W = dict(kind="softbounds", dw_min=1e-4, sigma_d2d=0.1, sigma_pm=0.3,
             sigma_c2c=0.05, drift_nu=0.06, drift_nu_std=0.02, drift_t0=20.0,
             prog_noise=0.01, prog_noise_slope=0.07, prog_rounds=3,
             read_noise=0.005)
DEV_P = dict(kind="softbounds", dw_min=1e-4, sigma_d2d=0.1, sigma_pm=0.3,
             sigma_c2c=0.05, ref_mean=0.1, ref_std=0.1)
CONFIGS = {"dev_w": DEV_W, "dev_p": DEV_P,
           "no_d2d": dict(sigma_d2d=0.0, sigma_pm=0.3),
           "no_d2d_target": dict(sigma_d2d=0.0, sigma_pm=0.3, tau_min=0.5,
                                 ref_mean=-0.1, ref_std=0.05)}
MEMBER = (33, 97)


def _ulp(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _words(n, seed):
    """``n`` key words with values past 2**31 (the int32 wrap)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64)


def _plain(seeds, shape, cfg):
    """The plain version's (gamma, rho) on the CPU as a dict."""
    gamma, rho = fastrng.hash_device_ref(seeds, shape, "cpu",
                                         **kref.device_scalars(cfg))
    return {"gamma": gamma, "rho": rho}


def _old_chain(seed, shape, cfg):
    """What ``sample_device(method="hash")`` ran before the op: three
    normal draws and the eager float math."""
    n_g, n_r, n_s = (fastrng.hash_normal(seed, shape, s, "cpu")
                     for s in (11, 13, 17))
    gamma = (torch.exp(cfg.sigma_d2d * n_g) if cfg.sigma_d2d > 0
             else torch.ones_like(n_g))
    rho = kref.clip_pm(cfg.sigma_pm * n_r, gamma)
    if cfg.ref_mean != 0.0 or cfg.ref_std != 0.0:
        w_star = cfg.ref_mean + cfg.ref_std * n_s
        w_star = torch.clamp(w_star, -0.95 * cfg.tau_min, 0.95 * cfg.tau_max)
        num = w_star * gamma * (cfg.tau_min + cfg.tau_max)
        den = (2.0 * cfg.tau_min * cfg.tau_max
               + w_star * (cfg.tau_min - cfg.tau_max))
        rho = kref.clip_pm(num / den, gamma)
    return gamma, rho


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_version_against_jax(name, n):
    words = _words(n, 11 + n)
    jcfg = jdev.DeviceConfig(**CONFIGS[name])
    want = [jdev.sample_device(
        jax.random.wrap_key_data(jnp.asarray(w.astype(np.uint32))), MEMBER,
        jcfg, method="hash") for w in words]
    want = {k: np.stack([np.asarray(d[k]) for d in want]) for k in
            ("gamma", "rho")}
    cfg = device.DeviceConfig(**CONFIGS[name])
    keys = torch.from_numpy(words.astype(np.int64))
    shape = (n,) + MEMBER if n > 1 else MEMBER
    seeds = fastrng.device_seeds(keys if n > 1 else keys[0], "cpu")
    got = _plain(seeds, shape, cfg)
    for k in ("gamma", "rho"):
        g = got[k].reshape((n,) + MEMBER).numpy()
        assert g.dtype == np.float32
        ulp = _ulp(g, want[k])
        if CONFIGS[name].get("sigma_d2d", 0.0) == 0.0:
            # no exp: the same float32 operations in the same order
            assert ulp.max() == 0, (k, ulp.max())
        else:
            # rule 4: XLA-CPU's exp against torch's, within 4 ULP
            assert ulp.max() <= 4, (k, ulp.max())
            assert (ulp > 0).mean() <= 0.05, (k, (ulp > 0).sum())
    if CONFIGS[name].get("sigma_d2d", 0.0) == 0.0:
        np.testing.assert_array_equal(got["gamma"].numpy(), 1.0)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_op_equals_plain_version_and_the_old_chain(name, n):
    cfg = device.DeviceConfig(**CONFIGS[name])
    keys = torch.from_numpy(_words(n, 21 + n).astype(np.int64))
    key = keys if n > 1 else keys[0]
    before = dict(ops.LAUNCHES)
    got = device.sample_device(key, MEMBER, cfg, method="hash", device="cpu")
    assert ops.LAUNCHES == before  # the plain path launches nothing
    shape = (n,) + MEMBER if n > 1 else MEMBER
    plain = _plain(fastrng.device_seeds(fastrng.seed_from_key(key), "cpu"),
                   shape, cfg)
    old = _old_chain(fastrng.seed_from_key(key), MEMBER, cfg)
    for k, o in zip(("gamma", "rho"), old):
        assert got[k].shape == shape and got[k].dtype == torch.float32
        assert torch.equal(got[k], plain[k])
        assert torch.equal(got[k], o)
    if n > 1:  # member i is the draw of key i alone
        for i in range(n):
            one = device.sample_device(keys[i], MEMBER, cfg, method="hash",
                                       device="cpu")
            assert torch.equal(got["rho"][i], one["rho"])


@pytest.mark.parametrize("name, salts", [("dev_w", [11, 13]),
                                         ("dev_p", [11, 17]),
                                         ("no_d2d", [13]),
                                         ("no_d2d_target", [17])])
def test_plain_version_draws_only_what_it_reads(monkeypatch, name, salts):
    """A ``dev_w`` draw makes no salt-17 draw; a target SP's no salt-13;
    without ``sigma_d2d`` no salt-11."""
    drawn = []
    real = fastrng.hash_normal_ref

    def counting(seed, shape, salt, dev="cuda"):
        drawn.append(salt)
        return real(seed, shape, salt, dev)

    monkeypatch.setattr(fastrng, "hash_normal_ref", counting)
    cfg = device.DeviceConfig(**CONFIGS[name])
    device.sample_device(prng.PRNGKey(5), (4, 6), cfg, method="hash",
                         device="cpu")
    assert sorted(drawn) == salts


def test_fake_rule_on_meta():
    cfg = device.DeviceConfig(**DEV_P)
    keys = torch.from_numpy(_words(4, 31).astype(np.int64))
    d = device.sample_device(keys, (896, 4864), cfg, method="hash",
                             device=META)
    for k in ("gamma", "rho"):
        assert d[k].device == META and d[k].shape == (4, 896, 4864)
        assert d[k].dtype == torch.float32
    one = device.sample_device(keys[0], (5, 7), cfg, method="hash",
                               device=META)
    assert one["gamma"].shape == one["rho"].shape == (5, 7)
    # one record a draw: 8 B an element written, 8 B a seed read
    with OpTrace() as tr:
        device.sample_device(keys, (896, 4864), cfg, method="hash",
                             device=META)
    (rec,) = tr.kernel_records("hash_device")
    assert rec.result_bytes() == 8 * 4 * 896 * 4864
    assert rec.operand_bytes() == 4 * 8
    assert op_cost.element_ops(rec) == 146 * 4 * 896 * 4864


@pytest.mark.parametrize("name, per", [("dev_w", 73 + 65), ("dev_p", 73 + 73),
                                       ("no_d2d", 65), ("no_d2d_target", 73)])
def test_draw_priced_from_its_config(name, per):
    """A record's operations are those its config draws, as
    ``roofline/op_cost.py`` counts the kernel's parts: gamma 73 (with
    sigma_d2d), rho 65, or 73 with a target SP."""
    cfg = device.DeviceConfig(**CONFIGS[name])
    keys = torch.from_numpy(_words(2, 41).astype(np.int64))
    with OpTrace() as tr:
        device.sample_device(keys, (33, 97), cfg, method="hash", device=META)
    (rec,) = tr.kernel_records("hash_device")
    assert rec.elem_ops == per
    assert op_cost.element_ops(rec) == per * 2 * 33 * 97
    assert op_cost.analyze_trace(tr).element_ops == per * 2 * 33 * 97


def _hash_trainer(backend):
    """The contracts' smallest grouped instance (three 2-member
    attention classes' worth of 8 x 8 tiles and an odd singleton) with
    hash noise and the devices drawn from the tile seeds every update."""
    from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
    from repro_torch.core.plan import AnalogPlan, TilePolicy
    from repro_torch.core.tile import TileConfig
    from repro_torch.core.trainer import AnalogTrainer, TrainerConfig

    tile = TileConfig(algorithm="erider",
                      device_p=device.DeviceConfig(**DEV_P),
                      device_w=device.DeviceConfig(**DEV_W), lr_p=0.5,
                      lr_w=0.5, gamma=0.1, eta=0.1, chopper_p=0.1,
                      store_device=False, rng="hash", update_backend=backend)
    cfg = TrainerConfig(tile=tile, digital=DigitalOptConfig(kind="sgd"),
                        schedule=ScheduleConfig(kind="constant",
                                                base_lr=0.1))

    def loss(params, batch, rng):
        return sum(torch.sum(v ** 2) for _, v in sorted(params.items())), {}

    tr = AnalogTrainer(loss, cfg, plan=AnalogPlan.of(
        ("**", TilePolicy(tile, name="hash"))))
    params = {f"l{i}/attn/{w}": torch.full((8, 8), 0.1)
              for i in range(3) for w in ("wq", "wo")}
    params["odd"] = torch.full((4, 24), 0.1)
    return tr, tr.init(prng.PRNGKey(0), params)


@pytest.mark.parametrize("backend", ["vmap", "fused"])
def test_step_draws_each_device_through_the_op(backend):
    """``algorithms._dev`` (vmap) and ``update_batched``'s ``dev_of``
    (fused) reach ``repro_torch::hash_device`` once per device draw, P's
    and W's of every K1 launch, and ``hash_normal`` never."""
    tr, state = _hash_trainer(backend)
    with OpTrace() as t:
        state, m = tr.train_step(state, {})
    draws = t.kernel_records("hash_device")
    k1 = t.kernel_records("analog_update")
    assert len(k1) > 0 and len(draws) == len(k1)
    assert all(r.name == "repro_torch.analog_update_hash.default"
               for r in k1)
    assert t.kernel_records("hash_normal") == []
    assert np.isfinite(float(m["loss"]))
