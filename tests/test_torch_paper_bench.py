"""The port's paper benchmarks (``repro_torch.benchmarks``) against the JAX
package's ``benchmarks/``, on the CPU.

* ``device_pair``, ``ALGO_HP`` and ``RunResult`` are the reference's.
* ``train_image_model``, 3 steps of 64 on a small ``ImageDataset`` on the
  Tables 1-2 device (~4 states, SP reference N(0.4, 0.4^2)), each package
  from its own init under the same seeds: per-step losses, the pulse
  total and ``sp_err`` within ``rtol=1e-5``, test accuracy within one test
  image. (Measured: losses within 1.5e-6, pulses within 3e-7, sp_err
  within 4e-7, relative; XLA-CPU and torch sum in other orders.)
* Each figure module's sweep, with ``train_image_model`` and
  ``zs.zs_estimate`` stubbed in both packages: the same calls with the
  same arguments (devices, data, hyper-parameters, seeds; ZS keys, device
  draws and budgets) and the same rows, but for the timing column.
* Fig. 2's mirror devices are not the tiles' devices, in both packages
  (a fault of the reference the port reproduces; ROADMAP queue 3).
* ``run.py`` refuses the two benchmarks it does not port yet, naming the
  ROADMAP item, and unknown names.
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as jbench  # noqa: E402
from repro.data import ImageDataset as JImageDataset  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.benchmarks import common as tbench  # noqa: E402
from repro_torch.data import ImageDataset  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests train for hundreds of steps of small element-wise ops.
    Under the suite's parallel workers torch's per-process thread pools
    oversubscribe the cores and every op waits on its slowest thread (an
    order of magnitude slower than the module alone), so it runs on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TABLES = dict(dw_min=0.4622, sigma_pm=0.7125, sigma_c2c=0.2174, ref_mean=0.4,
              ref_std=0.4)


def test_device_pair_hp_and_result_fields_match_reference():
    for kw in ({}, TABLES, dict(dw_min=0.25, sigma_pm=0.5, sigma_c2c=0.2)):
        for t, j in zip(tbench.device_pair(**kw), jbench.device_pair(**kw)):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tbench.ALGO_HP == jbench.ALGO_HP
    assert list(tbench.ALGO_HP) == list(jbench.ALGO_HP)
    assert [f.name for f in dataclasses.fields(tbench.RunResult)] \
        == [f.name for f in dataclasses.fields(jbench.RunResult)]
    assert tbench.csv_row("x", 1.5, "a=1") == jbench.csv_row("x", 1.5, "a=1")


def _sp_estimates(seed=5):
    rng = np.random.default_rng(seed)
    return {p: rng.normal(0.4, 0.2, s).astype(np.float32)
            for p, s in (("fc1/w", (784, 256)), ("fc2/w", (256, 128)),
                         ("out/w", (128, 10)))}


@pytest.mark.parametrize("kind,algo", [
    ("fcn", "erider"), ("fcn", "ttv2"), ("fcn", "agad"), ("fcn", "residual"),
    ("lenet5", "erider"), ("lenet5", "ttv2")])
def test_train_image_model_3_steps_match_reference(kind, algo):
    kw = dict(algorithm=algo, model_kind=kind, epochs=1, seed=1)
    sp = _sp_estimates() if algo == "residual" else None
    want = jbench.train_image_model(
        dev_p=jbench.device_pair(**TABLES)[0], dev_w=jbench.device_pair(**TABLES)[1],
        data=JImageDataset(n_train=192, n_test=256, seed=11),
        sp_estimates=sp and {p: jnp.asarray(v) for p, v in sp.items()}, **kw)
    got = tbench.train_image_model(
        dev_p=tbench.device_pair(**TABLES)[0], dev_w=tbench.device_pair(**TABLES)[1],
        data=ImageDataset(n_train=192, n_test=256, seed=11),
        sp_estimates=sp and {p: torch.from_numpy(v) for p, v in sp.items()},
        device="cpu", **kw)
    assert got.algorithm == want.algorithm == algo
    assert len(got.losses) == len(want.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_allclose(got.pulses, want.pulses, rtol=1e-5)
    assert got.pulses > 0
    assert (got.sp_err is None) == (want.sp_err is None) == (algo == "ttv2")
    if want.sp_err is not None:
        np.testing.assert_allclose(got.sp_err, want.sp_err, rtol=1e-5)
    assert abs(got.test_acc - want.test_acc) <= 1 / 256
    assert got.steps_to_target == want.steps_to_target == -1
    assert got.wall_s > 0


# ---------------------------------------------------------------------------
# the figure modules' sweeps, training stubbed
# ---------------------------------------------------------------------------

def _norm(v):
    """Call arguments as plain data: dataclasses as dicts, datasets by their
    sizes and seed, tensors and arrays as float64 numpy."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if hasattr(v, "x_train"):
            return ("data", v.n_train, v.n_test, v.seed)
        return dataclasses.asdict(v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return np.asarray(v.detach().cpu().numpy(), np.float64)
    if isinstance(v, (jax.Array, np.ndarray)):
        return np.asarray(v, np.float64)
    return v


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=path)
    else:
        assert a == b, (path, a, b)


class _Recorder:
    """A stand-in for ``train_image_model``: records its arguments and
    returns a fixed result, so that both packages emit the same values."""

    def __init__(self, result_cls):
        self.calls, self.result_cls = [], result_cls

    def __call__(self, **kw):
        self.calls.append(kw)
        return self.result_cls(
            algorithm=kw.get("algorithm", "erider"),
            losses=[2.0 - 0.01 * i for i in range(40)], test_acc=0.625,
            pulses=1234.5, sp_err=0.0625, steps_to_target=17, wall_s=0.0)


def _key_words(k):
    if isinstance(k, torch.Tensor):
        return tuple(int(x) & 0xFFFFFFFF for x in prng.key_data(k).tolist())
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _digest(x):
    """A tensor or array by its first elements and its moments."""
    a = _norm(x).reshape(-1)
    return np.concatenate([a[:16], [a.sum(), (a * a).sum()]])


class _ZsRecorder:
    """A stand-in for ``zs.zs_estimate``: records (key, w0, device draws,
    config, pulses, options) and returns ``w0`` (the estimate never
    converges, so the sweeps run their whole course)."""

    def __init__(self):
        self.calls = []

    def __call__(self, key, w0, dp, cfg, n_pulses, **opts):
        self.calls.append(dict(key=_key_words(key), shape=tuple(w0.shape),
                               w0=_digest(w0),
                               dp={k: _digest(v) for k, v in dp.items()},
                               cfg=_norm(cfg), n=n_pulses, opts=opts))
        return w0


def _strip_time(rows):
    out = []
    for r in rows:
        name, _, derived = r.split(",", 2)
        out.append((name, derived))
    return out


FIGS = ["fig1_zs", "fig2_sp_error", "fig4_pulse_cost",
        "fig5_table9_10_ablations", "table12_robustness"]


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("fig", FIGS)
def test_figure_sweep_matches_reference(fig, quick, monkeypatch):
    jmod = importlib.import_module(f"benchmarks.{fig}")
    tmod = importlib.import_module(f"repro_torch.benchmarks.{fig}")
    from repro.core import zs as jzs
    from repro_torch.core import zs as tzs

    runs = {}
    for name, mod, zmod, res in (("jax", jmod, jzs, jbench.RunResult),
                                 ("torch", tmod, tzs, tbench.RunResult)):
        rec, zrec = _Recorder(res), _ZsRecorder()
        if hasattr(mod, "train_image_model"):
            monkeypatch.setattr(mod, "train_image_model", rec)
        monkeypatch.setattr(zmod, "zs_estimate", zrec)
        rows = mod.run(quick) if name == "jax" else mod.run(quick, device="cpu")
        runs[name] = (rows, rec.calls, zrec.calls)

    (jrows, jcalls, jz), (trows, tcalls, tz) = runs["jax"], runs["torch"]
    assert _strip_time(trows) == _strip_time(jrows)
    assert len(tcalls) == len(jcalls)
    for t, j in zip(tcalls, jcalls):
        assert t.pop("device") == "cpu"
        _same(_norm(t), _norm(j))
    assert len(tz) == len(jz)
    for t, j in zip(tz, jz):
        _same(t, j)
    if fig != "fig1_zs":
        assert jcalls, "the sweep trained nothing"
    if fig in ("fig1_zs", "fig2_sp_error"):
        assert jz, "the sweep ran no ZS estimate"


def test_fig2_mirror_devices_are_not_the_tiles_devices():
    """Reference fault, reproduced: fig2 estimates SPs of devices drawn from
    ``fold_in(PRNGKey(1), i)``, not of the tiles' own ``dev_p`` (drawn from
    the CRC of the path by ``trainer.init``), in both packages."""
    from repro_torch.benchmarks import fig2_sp_error
    from repro_torch.models import convnets

    dev_p, dev_w = tbench.device_pair(dw_min=0.01, ref_mean=0.3, ref_std=0.3)
    mirror = fig2_sp_error.mirror_devices(dev_p, "cpu")
    trainer, ccfg, _ = tbench.image_trainer("residual", "fcn", dev_p, dev_w)
    state = trainer.init(prng.PRNGKey(1),
                         convnets.init_convnet(prng.PRNGKey(0), ccfg, "cpu"))
    bank = state["tiles"]
    tiles = {p: bank.classes[c]["dev_p"]
             for c, gnames in bank.class_index
             for g in gnames for p in dict(bank.index)[g]}
    assert sorted(mirror) == sorted(tiles) == ["fc1/w", "fc2/w", "out/w"]

    # the reference draws the same two sets
    from repro.core.device import sample_device as jsample
    from repro.core.trainer import _crc_fold
    jdev_p = jbench.device_pair(dw_min=0.01, ref_mean=0.3, ref_std=0.3)[0]
    for i, p in enumerate(sorted(mirror)):
        _, shape, dp = mirror[p]
        tile_gamma = tiles[p]["gamma"].reshape(shape).numpy()
        kp = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), i), 3)[0]
        np.testing.assert_allclose(dp["gamma"].numpy(),
                                   np.asarray(jsample(kp, shape, jdev_p)["gamma"]),
                                   rtol=1e-6)
        ktile = jax.random.split(_crc_fold(jax.random.PRNGKey(1), p), 3)[0]
        np.testing.assert_allclose(tile_gamma,
                                   np.asarray(jsample(ktile, shape, jdev_p)["gamma"]),
                                   rtol=1e-6)
        # ... and they are other draws: no element in common
        assert np.mean(np.isclose(dp["gamma"].numpy(), tile_gamma)) < 0.01, p


@pytest.mark.parametrize("argv,msg", [
    (["--only", "fig1,tile_engine"], "ROADMAP item 16b"),
    (["--only", "fig9"], "unknown benchmark"),
])
def test_run_refuses_what_it_does_not_run(argv, msg):
    from repro_torch.benchmarks import run

    with pytest.raises(SystemExit) as e:
        run.main(argv + ["--device", "cpu"])
    assert msg in str(e.value)


def test_run_prints_the_roofline_report(tmp_path, monkeypatch, capsys):
    """``--only roofline`` tabulates the dry run's cells under
    ``results/dryrun`` (here one skipped cell and one traced long-context
    cell, as ``launch.dryrun.run_cell`` writes them)."""
    from repro_torch.benchmarks import run
    from repro_torch.launch import dryrun

    monkeypatch.chdir(tmp_path)
    for arch in ("qwen3-14b", "mamba2-2.7b"):
        dryrun.run_cell(arch, "long_500k", multi_pod=False,
                        out_dir="results/dryrun")
    capsys.readouterr()
    assert run.main(["--only", "roofline", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == ["# device: cpu", "name,us_per_call,derived",
                       "roofline_cells,0,ok=1;skipped=1;errors=0"]
    assert out[3].startswith("roofline_mamba2-2.7b_long_500k_pod16x16,0,"
                             "bottleneck=")
    assert out[4].startswith("total,")


def test_entry_points_refuse_to_fall_back_without_a_card():
    """``run.py``, the example and ``train_image_model`` run on the card by
    default and never carry on on the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import runpy

    from repro_torch.benchmarks import run

    with pytest.raises(SystemExit) as e:
        run.main(["--only", "fig4"])
    assert "no CUDA device" in str(e.value)
    example = runpy.run_path(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "torch_analog_mnist.py"))
    with pytest.raises(SystemExit) as e:
        example["main"]([])
    assert "no CUDA device" in str(e.value)
    pair = tbench.device_pair()
    with pytest.raises((RuntimeError, AssertionError)):
        tbench.train_image_model(dev_p=pair[0], dev_w=pair[1], epochs=1,
                                 data=ImageDataset(n_train=64, n_test=256))
