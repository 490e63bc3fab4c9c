"""The port's trainer against the JAX package's, end to end on the CPU.

* Quickstart (E-RIDER, 32x32, 100 steps, each package from its own init
  under the same seeds): ``true_loss``, ``tile/sp_err`` and ``tile/pulses``
  within ``rtol=1e-5`` of the JAX run at every step. XLA-CPU fuses
  multiply-adds and sums in another order, so the two runs differ by
  float32 ULPs that never reach a pulse decision here.
* The paper's FCN at full width (784-256-128-10, E-RIDER with the benchmark
  hyper-parameters), 3 steps from one state carried across with
  ``repro_torch.convert``: loss within ``rtol=1e-5``; W within 1e-5 on all
  but at most 0.1 % of the elements. A ULP difference can flip one
  stochastic-rounding pulse, which moves that element by a whole pulse
  (>= 1e-3 here): every element off by more than 1e-5 must be such a flip.
* Group and class names equal the JAX package's for both parameter trees.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core.device import DeviceConfig as JDev  # noqa: E402
from repro.core.digital_opt import DigitalOptConfig as JOpt  # noqa: E402
from repro.core.digital_opt import ScheduleConfig as JSched  # noqa: E402
from repro.core.tile import TileConfig as JTile  # noqa: E402
from repro.core.trainer import AnalogTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.data import ImageDataset as JImageDataset  # noqa: E402
from repro.models import convnets as jconv  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core.device import DeviceConfig  # noqa: E402
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig  # noqa: E402
from repro_torch.core.plan import AnalogPlan, TilePolicy  # noqa: E402
from repro_torch.core.tile import TileConfig  # noqa: E402
from repro_torch.core.trainer import AnalogTrainer, TrainerConfig  # noqa: E402
from repro_torch.data import ImageDataset  # noqa: E402
from repro_torch.models import convnets  # noqa: E402

from repro_torch.benchmarks import common as tbench  # noqa: E402

QS_KEYS = ("true_loss", "tile/sp_err", "tile/pulses")


def _jax_quickstart():
    import examples.quickstart as jq

    dev_p = JDev(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05,
                 ref_mean=0.3, ref_std=0.2)
    dev_w = JDev(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
    pol = jplan.TilePolicy(
        JTile(algorithm="erider", device_p=dev_p, device_w=dev_w, lr_p=0.5,
              lr_w=0.5, gamma=0.1, eta=0.3, chopper_p=0.1), name="erider")
    return JTrainer(jq.loss_fn,
                    JTrainerConfig(digital=JOpt(kind="sgd"),
                                   schedule=JSched(kind="constant", base_lr=0.1)),
                    plan=jplan.AnalogPlan.of(("**", pol)))


def test_quickstart_100_steps_match_jax():
    import examples.torch_quickstart as tq

    jtr = _jax_quickstart()
    js = jtr.init(jax.random.PRNGKey(2), {"w": jnp.zeros((32, 32))})
    ttr = tq.make_trainer("cpu")
    ts = ttr.init(prng.PRNGKey(2), {"w": torch.zeros(32, 32)})
    assert list(ts["tiles"].classes) == list(js["tiles"].classes) \
        == ["g32x32_float32_nn"]
    assert ttr.describe_plan({"w": torch.zeros(32, 32)}) \
        == jtr.describe_plan({"w": jnp.zeros((32, 32))})
    step = jtr.jit_step()
    for i in range(100):
        js, jm = step(js, jnp.zeros(()))
        ts, tm = ttr.train_step(ts, None)
        for k in QS_KEYS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert float(tm["true_loss"]) < 1.25 and float(tm["tile/sp_err"]) < 0.13


def _fcn_trainers(backend="vmap"):
    """The reference's benchmark set-up and the port's copy of it."""
    from benchmarks import common as jbench

    dev_p, dev_w = jbench.device_pair()
    jt = JTile(algorithm="erider", device_p=dev_p, device_w=dev_w,
               update_backend=backend, **jbench.ALGO_HP["erider"])
    assert tbench.ERIDER_HP == jbench.ALGO_HP["erider"]
    assert JDev(**tbench.FCN_DEVICE) == dev_p == dev_w
    jtr = JTrainer(
        jconv.make_loss_fn(jconv.ConvNetConfig()),
        JTrainerConfig(tile=jt, digital=JOpt(kind="sgdm", momentum=0.5),
                       schedule=JSched(kind="constant", base_lr=0.2)),
        plan=jplan.AnalogPlan.of(
            (jconv.analog_filter, jplan.TilePolicy(jt, name="erider")),
            analog_min_ndim=0))
    return jtr, tbench.fcn_trainer(backend)


def _carry(js):
    bank = js["tiles"]
    return convert.train_state({
        "step": js["step"], "key": js["key"],
        "params": jax.tree.map(np.asarray, js["params"]),
        "opt": jax.tree.map(np.asarray, js["opt"]),
        "tiles": {"classes": {c: jax.tree.map(np.asarray, st)
                              for c, st in bank.classes.items()},
                  "index": bank.index, "class_index": bank.class_index,
                  "policies": {g: jplan.policy_to_json(p)
                               for g, p in bank.policies.items()}},
    }, "cpu")


def test_fcn_full_width_3_steps_match_jax():
    jtr, ttr = _fcn_trainers()
    jparams = jconv.init_convnet(jax.random.PRNGKey(0), jconv.ConvNetConfig())
    js = jtr.init(jax.random.PRNGKey(1), jparams)
    ts = _carry(js)
    names = ["g128x10_float32_nM", "g256x128_float32_nM", "g784x256_float32_nM"]
    assert list(js["tiles"].classes) == names
    assert list(ts["tiles"].classes) == names
    assert ts["tiles"].index == js["tiles"].index
    data = JImageDataset(n_train=192, n_test=64, seed=11)
    step = jtr.jit_step(donate=False)
    for b in data.epoch(0, 64):
        js, jm = step(js, {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])})
        ts, tm = ttr.train_step(ts, {"x": torch.from_numpy(b["x"]),
                                     "y": torch.from_numpy(b["y"])})
        for k in ("loss", "accuracy", "tile/pulses", "tile/sp_err",
                  "tile/gp_sq"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    for c in names:
        want = np.asarray(js["tiles"].classes[c]["W"])
        got = ts["tiles"].classes[c]["W"].numpy()
        diff = np.abs(got - want)
        off = diff > 1e-5
        assert off.mean() <= 1e-3, (c, off.mean())
        # each such element is a flipped pulse, not drift
        assert np.all(diff[off] >= 1e-3), (c, diff[off])
    for k in ("fc1", "fc2", "out"):
        np.testing.assert_allclose(ts["params"][k]["b"].numpy(),
                                   np.asarray(js["params"][k]["b"]),
                                   rtol=1e-5, atol=1e-7)


def test_fcn_init_and_names_match_jax():
    """The port's own FCN init (truncated normal, tile init) against the
    JAX package's, to a few ULP."""
    jtr, ttr = _fcn_trainers("fused")
    jparams = jconv.init_convnet(jax.random.PRNGKey(0), jconv.ConvNetConfig())
    tparams = convnets.init_convnet(prng.PRNGKey(0), convnets.ConvNetConfig(),
                                    "cpu")
    for k in ("fc1", "fc2", "out"):
        np.testing.assert_allclose(tparams[k]["w"].numpy(),
                                   np.asarray(jparams[k]["w"]), rtol=1e-6,
                                   atol=1e-7)
    assert ttr.describe_plan(tparams) == jtr.describe_plan(jparams)
    ts = ttr.init(prng.PRNGKey(1), tparams)
    js = jtr.init(jax.random.PRNGKey(1), jparams)
    assert ts["tiles"].class_index == js["tiles"].class_index
    for c, st in js["tiles"].classes.items():
        np.testing.assert_allclose(ts["tiles"].classes[c]["dev_p"]["gamma"].numpy(),
                                   np.asarray(st["dev_p"]["gamma"]), rtol=2e-6)


def test_synthetic_images_identical():
    a = ImageDataset(n_train=64, n_test=32, seed=3)
    b = JImageDataset(n_train=64, n_test=32, seed=3)
    np.testing.assert_array_equal(a.x_train, b.x_train)
    np.testing.assert_array_equal(a.y_test, b.y_test)
    for x, y in zip(a.epoch(1, 16), b.epoch(1, 16)):
        np.testing.assert_array_equal(x["x"], y["x"])


def _mlp_loss(lib):
    """0.5 * mean((x @ w + b - y)^2) in either package."""
    def loss_fn(params, batch, rng):
        pred = batch["x"] @ params["lin"]["w"] + params["lin"]["b"]
        err = pred - batch["y"]
        return 0.5 * lib.mean(err * err), {"mse": lib.mean(err * err)}
    return loss_fn


@pytest.mark.parametrize("engine", ["grouped", "looped"])
def test_microbatch_adam_engines_match_jax(engine):
    """Microbatch accumulation, Adam on the digital bias and both tile
    engines, 3 steps against the JAX package."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    y = rng.standard_normal((8, 6)).astype(np.float32)
    w0 = (0.1 * rng.standard_normal((12, 6))).astype(np.float32)
    dev = dict(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
    kw = dict(microbatch=2, engine=engine)
    jtr = JTrainer(_mlp_loss(jnp), JTrainerConfig(
        tile=JTile(algorithm="rider", device_p=JDev(**dev), device_w=JDev(**dev)),
        digital=JOpt(kind="adam"), schedule=JSched(kind="cosine", base_lr=0.1,
                                                   warmup_steps=2,
                                                   total_steps=6), **kw),
        plan=jplan.AnalogPlan.of(("**/w", jplan.TilePolicy.of("rider", JDev(**dev)))))
    ttr = AnalogTrainer(_mlp_loss(torch), TrainerConfig(
        tile=TileConfig(algorithm="rider", device_p=DeviceConfig(**dev),
                        device_w=DeviceConfig(**dev)),
        digital=DigitalOptConfig(kind="adam"),
        schedule=ScheduleConfig(kind="cosine", base_lr=0.1, warmup_steps=2,
                                total_steps=6), **kw),
        plan=AnalogPlan.of(("**/w", TilePolicy.of("rider", DeviceConfig(**dev)))))
    js = jtr.init(jax.random.PRNGKey(0), {"lin": {"w": jnp.asarray(w0),
                                                  "b": jnp.zeros(6)}})
    ts = ttr.init(prng.PRNGKey(0), {"lin": {"w": torch.from_numpy(w0),
                                            "b": torch.zeros(6)}})
    step = jtr.jit_step(donate=False)
    for _ in range(3):
        js, jm = step(js, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        ts, tm = ttr.train_step(ts, {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y)})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-8, err_msg=k)
    np.testing.assert_allclose(ts["params"]["lin"]["b"].numpy(),
                               np.asarray(js["params"]["lin"]["b"]), rtol=1e-5,
                               atol=1e-7)
    tw = (ts["tiles"]["lin/w"] if engine == "looped"
          else ts["tiles"].classes["g12x6_float32_nM"])["W"]
    jw = (js["tiles"]["lin/w"] if engine == "looped"
          else js["tiles"].classes["g12x6_float32_nM"])["W"]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


def test_entry_points_default_to_the_card():
    """Without a card, entry points called without device='cpu' fail
    loudly instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        convnets.init_convnet(prng.PRNGKey(0), convnets.ConvNetConfig())
    with pytest.raises((RuntimeError, AssertionError)):
        prng.normal(prng.PRNGKey(0), (4,))
