"""The port's serve CLI (``repro_torch.launch.serve``) against the JAX
package's, on the CPU.

* ``parse_age``: the reference's ``tests/test_lifetime.py``
  ``test_parse_age_units`` on the port, and the unit table equal.
* ``build_workload`` gives byte-equal prompts, generation lengths,
  arrivals and seeds for the plain, mixed-length, staggered and
  shared-prefix traces; ``data_vocab=N`` gives the trace the reference
  draws for a model of N ids (the reference's ``BigramLM`` table is
  (V, V), 185 GB at 151936 ids).
* ``main([... "--device", "cpu", "--dump-tokens", ...])`` writes the same
  JSON as ``repro.launch.serve.main`` for the qwen2 smoke config under
  both engines (parameters from ``PRNGKey(0)`` in each package; the
  port's init is within 4 float32 ULP of JAX's).
* The encoder-decoder (seamless-m4t-large-v2) through both CLIs: each
  falls back to its fixed driver, which feeds ``FeedBuilder``'s frames to
  the encoder; the same tokens. ``examples/torch_serve_decode.py
  --device cpu`` (mamba2) writes ``examples/serve_decode.py``'s tokens.
* A smoke checkpoint written by the port's training CLI, served through
  both CLIs aged one year with GDC (a checkpoint of either package
  restores bit-exactly in the other): the same tokens; the effective parameters of
  ``load_effective_params`` within ``rtol=5e-6`` plus ``1e-6 * amax|w|``
  (the aged weights' cross-framework tolerance of ROADMAP queue 3, times
  an alpha within 1e-6 of JAX's); the lifetime reports carry the same
  fields, ``t0_signature``, per-class drift scales within 1e-6.
"""
import dataclasses
import json
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SMOKE = ["--arch", "qwen2-0.5b", "--smoke", "--requests", "4",
         "--prompt-len", "12", "--gen", "6", "--batch", "2"]


def test_parse_age_units():
    parse_age = serve.parse_age
    assert parse_age("0") == 0.0
    assert parse_age("90s") == 90.0
    assert parse_age("1.5h") == pytest.approx(5400.0)
    assert parse_age("1yr") == pytest.approx(31557600.0)
    with pytest.raises(ValueError):
        parse_age("10 parsecs")
    with pytest.raises(ValueError):
        parse_age("fast")
    assert serve.AGE_UNITS == jserve.AGE_UNITS
    for text in ("0", "90", "5min", "1h", "1d", "1mo", "2.5yr", " 3 d "):
        assert serve.parse_age(text) == jserve.parse_age(text)


@pytest.mark.parametrize("kw", [
    {}, {"gen_spread": 3}, {"arrival_every": 2}, {"prefix_len": 5},
    {"seed": 11, "gen_spread": 1, "prefix_len": 3}])
def test_build_workload_byte_equal(kw):
    for arch in ("qwen2-0.5b", "gemma3-4b"):
        got = serve.build_workload(get_config(arch, smoke=True), 6, 12, 5, **kw)
        want = jserve.build_workload(jget(arch, smoke=True), 6, 12, 5, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.prompt.dtype == w.prompt.dtype == np.int32
            assert g.prompt.tobytes() == w.prompt.tobytes()
            assert (g.request_id, g.max_new_tokens, g.arrival_step, g.seed) \
                == (w.request_id, w.max_new_tokens, w.arrival_step, w.seed)


def test_build_workload_data_vocab():
    cfg = get_config("qwen2-0.5b", smoke=True)
    got = serve.build_workload(cfg, 3, 12, 4, data_vocab=64)
    want = jserve.build_workload(
        dataclasses.replace(jget("qwen2-0.5b", smoke=True), vocab=64), 3, 12, 4)
    assert [g.prompt.tobytes() for g in got] == [w.prompt.tobytes() for w in want]
    assert max(int(g.prompt.max()) for g in got) < 64
    default = serve.build_workload(cfg, 3, 12, 4)
    assert [g.prompt.tobytes() for g in default] == [
        w.prompt.tobytes() for w in jserve.build_workload(
            jget("qwen2-0.5b", smoke=True), 3, 12, 4)]
    with pytest.raises(ValueError, match="data-vocab"):
        serve.build_workload(cfg, 1, 4, 1, data_vocab=cfg.vocab + 1)


def _dump(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_main_writes_the_reference_tokens(engine, tmp_path):
    argv = SMOKE + ["--engine", engine, "--prefix-len", "4"]
    jserve.main(argv + ["--dump-tokens", str(tmp_path / "jax.json")])
    results, summary, eng = serve.main(
        argv + ["--device", "cpu", "--dump-tokens", str(tmp_path / "port.json"),
                "--manifest", str(tmp_path / "m.json")])
    assert _dump(tmp_path / "port.json") == _dump(tmp_path / "jax.json")
    assert summary["generated_tokens"] == 4 * 6
    assert (eng is None) == (engine == "fixed")
    manifest = _dump(tmp_path / "m.json")
    assert manifest["engine"]["mode"] == engine
    assert "lifetime" not in manifest


def test_encdec_falls_back_to_the_fixed_driver_with_jax_tokens(tmp_path,
                                                               capsys):
    argv = ["--arch", "seamless-m4t-large-v2", "--smoke", "--requests", "4",
            "--prompt-len", "12", "--gen", "6", "--batch", "2"]
    jserve.main(argv + ["--dump-tokens", str(tmp_path / "jax.json")])
    results, summary, eng = serve.main(
        argv + ["--device", "cpu", "--dump-tokens", str(tmp_path / "port.json")])
    assert eng is None and summary["generated_tokens"] == 4 * 6
    assert "falling back to the fixed-batch engine" in capsys.readouterr().out
    assert _dump(tmp_path / "port.json") == _dump(tmp_path / "jax.json")


def test_serve_decode_example_writes_the_reference_tokens(tmp_path,
                                                         monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for script, extra, out in (
            ("serve_decode.py", [], "jax.json"),
            ("torch_serve_decode.py", ["--device", "cpu"], "port.json")):
        monkeypatch.setattr("sys.argv", [script] + extra + [
            "--dump-tokens", str(tmp_path / out)])
        runpy.run_path(f"{root}/examples/{script}", run_name="__main__")
    got = _dump(tmp_path / "port.json")
    assert len(got) == 8 and all(len(v) == 16 for v in got.values())
    assert got == _dump(tmp_path / "jax.json")


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A qwen2 smoke checkpoint written by the port's training CLI (step 2,
    with the GDC t0 signatures in its manifest)."""
    from repro_torch.launch import train

    d = str(tmp_path_factory.mktemp("ck"))
    train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "2",
                "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                "--ckpt-dir", d, "--device", "cpu"])
    return d


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_port_checkpoint_aged_with_gdc_through_both_clis(engine, port_ckpt,
                                                         tmp_path):
    argv = SMOKE + ["--engine", engine, "--ckpt-dir", port_ckpt,
                    "--algorithm", "erider", "--age", "1yr", "--gdc", "on"]
    jserve.main(argv + ["--dump-tokens", str(tmp_path / "jax.json")])
    serve.main(argv + ["--device", "cpu", "--manifest", str(tmp_path / "m.json"),
                       "--dump-tokens", str(tmp_path / "port.json")])
    assert _dump(tmp_path / "port.json") == _dump(tmp_path / "jax.json")
    life = _dump(tmp_path / "m.json")["lifetime"]
    assert life["t0_signature"] == "checkpoint" and life["gdc"] is True
    assert life["age_s"] == pytest.approx(31557600.0)


def test_effective_params_and_report_match_jax(port_ckpt):
    from repro.models.lm import LM as JLM
    from repro.serving import load_effective_params as jload
    from repro_torch.models.lm import LM
    from repro_torch.serving import load_effective_params

    age = serve.parse_age("1yr")
    want, wrep = jload(JLM(jget("qwen2-0.5b", smoke=True)), port_ckpt,
                       "erider", True, age_s=age, gdc=True, with_report=True)
    got, grep = load_effective_params(
        LM(get_config("qwen2-0.5b", smoke=True)), port_ckpt, "erider", True,
        age_s=age, gdc=True, with_report=True, device="cpu")
    want = dict(flatten_with_path(jax.tree.map(np.asarray, want)))
    got = dict(flatten_with_path(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].float().numpy()
        amax = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=5e-6, atol=1e-6 * amax,
                                   err_msg=path)
    assert {k: grep[k] for k in ("age_s", "gdc", "t0_signature")} == \
        {k: wrep[k] for k in ("age_s", "gdc", "t0_signature")}
    assert sorted(grep["drift_scale"]) == sorted(wrep["drift_scale"])
    for c, w in wrep["drift_scale"].items():
        assert sorted(grep["drift_scale"][c]) == sorted(w)
        for k, v in w.items():
            assert grep["drift_scale"][c][k] == pytest.approx(v, rel=1e-6), (c, k)
        assert w["min"] > 1.0          # a year of drift: every alpha above 1
