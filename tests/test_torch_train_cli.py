"""The port's training CLI (``repro_torch.launch.train``) on the CPU, against
the JAX package's (``repro.launch.train``).

* ``python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --device
  cpu`` trains 6 steps with checkpoints every 3, and a second run with
  ``--steps 8`` restores step 6 (the reference's
  ``tests/test_system.py::test_train_cli_with_restart``).
* Checkpoints cross between the two CLIs, on the mixed plan
  ``attn=rider,**=erider``: the port's CLI resumes from a JAX checkpoint
  and the JAX CLI from the port's; the JAX package restores the port's
  checkpoint bit for bit. The port's ``gdc_signatures`` agree with the JAX
  package's ``ckpt_extra`` on the same state within 1e-6 relative (the
  two frameworks sum ``x @ w`` in other orders, ROADMAP queue 3).
* The tile configs of ``make_tile_cfg`` equal the reference's (dtypes by
  name), a mesh without a process group of its size is refused, and
  ``--data-vocab`` (the port's own flag) bounds the token stream.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.trainer import AnalogTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MIXED = "attn=rider,**=erider"


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    """Both CLIs' PreemptionHandler takes SIGTERM/SIGINT in the process that
    runs ``main``; give them back to the test worker afterwards."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _run_cli(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                         + args, env=env, timeout=timeout,
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_with_restart(tmp_path):
    ck = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "m.json")
    common = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "4", "--seq",
              "32", "--ckpt-dir", ck, "--device", "cpu"]
    out = _run_cli(common + ["--steps", "6", "--ckpt-every", "3",
                             "--metrics-out", metrics])
    assert "plan: 12 analog paths -> 8 groups" in out
    assert "done" in out
    assert ckpt.latest_step(ck) == 6
    assert "gdc_signatures" in ckpt.read_manifest(ck, 3)
    with open(metrics) as f:
        hist = json.load(f)
    assert [m["step"] for m in hist] == [0, 5]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["tile/sp_err"])
               for m in hist)
    out2 = _run_cli(common + ["--steps", "8"])
    assert "restored checkpoint at step 6" in out2
    assert "[train] step=7 " in out2


@contextlib.contextmanager
def _one_thread():
    """A smoke run is thousands of small ops; the test workers share the
    machine's cores, where one intra-op thread a worker runs them several
    times faster than a full pool each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_cli(argv):
    """``train.main(argv)`` with one intra-op thread."""
    with _one_thread():
        return train.main(argv)


def check_cli_restart(arch, root, extra=()):
    """``train.main`` on the smoke config of ``arch`` (``--device cpu``): a
    4-step run with checkpoints every 2 against the same run cut after its
    step-2 checkpoint and restarted, bit-equal on every leaf; every logged
    loss and ``tile/sp_err`` finite. Returns the unbroken run's history."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir",
            str(root), "--steps", "4", "--log-every", "1", *extra]
    state_a, hist_a = run_cli(argv + ["--ckpt-every", "2"])
    assert [m["step"] for m in hist_a] == [0, 1, 2, 3]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["tile/sp_err"])
               for m in hist_a)
    assert ckpt.latest_step(str(root)) == 4
    shutil.rmtree(os.path.join(str(root), "step_000000004"))
    state_b, hist_b = run_cli(argv)
    assert [m["step"] for m in hist_b] == [2, 3]
    a = dict(flatten_with_path(convert.to_numpy(state_a)))
    b = dict(flatten_with_path(convert.to_numpy(state_b)))
    assert sorted(a) == sorted(b)
    for p in a:
        assert np.array_equal(a[p], b[p]), p
    return hist_a


def _jax_state_template(spec: str):
    """The JAX CLI's state structure for the smoke qwen2 (a restore
    template; its values are overwritten)."""
    model = JLM(jget("qwen2-0.5b", smoke=True))
    trainer = JTrainer(model.loss, JTrainerConfig(),
                       plan=jtrain.make_plan(spec, True))
    params = model.init(jax.random.PRNGKey(0))
    return trainer, trainer.init(jax.random.PRNGKey(1), params)


def test_checkpoints_cross_between_the_port_and_jax_clis(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    common = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq",
              "16", "--algorithm", MIXED, "--ckpt-dir", ck]
    # the JAX CLI writes step 2; the port's CLI resumes from it to step 3
    jtrain.main(common + ["--steps", "2", "--ckpt-every", "2"])
    capsys.readouterr()
    state, hist = train.main(common + ["--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out
    assert [m["step"] for m in hist] == [2] and int(state["step"]) == 3
    port_sigs = ckpt.read_manifest(ck, 3)["gdc_signatures"]

    # the JAX package restores the port's step 3 bit for bit
    jtrainer, template = _jax_state_template(MIXED)
    restored = jckpt.restore(template, ck, 3)
    want = dict(flatten_with_path(convert.to_numpy(state)))
    got = dict(flatten_with_path(jax.tree.map(np.asarray, {
        "step": restored["step"], "key": restored["key"],
        "params": restored["params"], "opt": restored["opt"],
        "tiles": restored["tiles"].classes})))
    assert sorted(got) == sorted(want)
    for p, a in got.items():
        b = want[p]
        if b.dtype == np.int64:  # keys and seeds: the port's uint32 form
            b = b.astype(np.uint32)
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    jsigs = jtrain.ckpt_extra(jtrainer, restored)["gdc_signatures"]
    assert sorted(jsigs) == sorted(port_sigs)
    for p, v in jsigs.items():
        assert abs(port_sigs[p] - v) <= 1e-6 * abs(v), p

    # ... and the JAX CLI resumes from it
    jtrain.main(common + ["--steps", "3"])
    assert "restored checkpoint at step 3" in capsys.readouterr().out


def _plain(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _plain(v)
        elif isinstance(v, torch.dtype):
            v = str(v).replace("torch.", "")
        elif isinstance(v, type) or type(v).__name__ == "_ScalarMeta":
            v = np.dtype(v).name
        out[f.name] = v
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_tile_configs_match_reference(smoke):
    for algo in ("erider", "rider"):
        assert _plain(train.make_tile_cfg(algo, smoke)) == \
            _plain(jtrain.make_tile_cfg(algo, smoke))


def test_cli_refuses_a_mesh_and_a_data_vocab_past_the_model():
    # a mesh needs a process group of its size (none in this process)
    with pytest.raises(ValueError, match=r"mesh of 2 ranks.*world size 1"):
        train.main(["--smoke", "--data-parallel", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="data-vocab"):
        train.main(["--smoke", "--data-vocab", "513", "--device", "cpu"])


def test_data_vocab_bounds_the_token_stream(monkeypatch):
    """``--data-vocab`` draws the bigram stream over the first V ids; the
    model keeps its vocabulary (the logits' width)."""
    seen = []
    loss = train.LM.loss

    def spy(self, params, batch, rng):
        seen.append(int(batch["tokens"].max()))
        return loss(self, params, batch, rng)

    monkeypatch.setattr(train.LM, "loss", spy)
    state, hist = train.main(["--smoke", "--steps", "2", "--batch", "8",
                              "--seq", "16", "--data-vocab", "40",
                              "--device", "cpu"])
    assert seen and max(seen) < 40 and len(hist) == 2
    assert tuple(state["params"]["embed"].shape) == (512, 64)
