"""The port stands alone and mirrors the reference's configuration surface.

* No module of ``src/repro_torch``, nor ``chip_smoke.py`` or the port's
  examples, imports ``jax`` or the ``repro`` package (AST scan).
* The port's config dataclasses carry the reference's field names and
  defaults (dtypes compared by name; the serving ones too: ``EngineConfig``,
  ``ServeDefaults``, ``ServeRequest``), and its rule tables and the
  per-family serving defaults are the same.
* The on-disk and stream constants are the reference's: the checkpoint
  chunk size, the lifetime RNG salts, and GDC's row-block count,
  reference-input salt and seed.
* ``chip_smoke.py`` refuses to run without a card: non-zero exit, no
  result line.
"""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "examples", "torch_quickstart.py"),
           os.path.join(ROOT, "examples", "torch_lm_analog_training.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, bad


def _norm(v):
    """A default as plain data: dtypes by name, dataclasses as dicts."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) or type(v).__name__ == "_ScalarMeta":
        return np.dtype(v).name  # jnp.float32
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name)) for f in dataclasses.fields(v)}
    return v


def _defaults(cls):
    return {f.name: _norm(f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", [
    "core.device.DeviceConfig", "core.tile.TileConfig",
    "core.trainer.TrainerConfig", "core.digital_opt.DigitalOptConfig",
    "core.digital_opt.ScheduleConfig", "models.convnets.ConvNetConfig",
    "core.plan.TilePolicy", "core.plan.AnalogPlan",
    "data.synthetic.BigramLM", "configs.base.ModelConfig",
    "configs.base.ShapeSpec", "distributed.fault.StragglerMonitor",
    "distributed.fault.RestartPolicy", "serving.engine.EngineConfig",
    "configs.serving.ServeDefaults", "serving.scheduler.ServeRequest",
])
def test_config_fields_and_defaults_match_reference(name):
    mod, cls = name.rsplit(".", 1)
    ref = getattr(importlib.import_module("repro." + mod), cls)
    port = getattr(importlib.import_module("repro_torch." + mod), cls)
    assert _defaults(port) == _defaults(ref)
    assert list(_defaults(port)) == list(_defaults(ref))  # same field order


@pytest.mark.parametrize("name", [
    "checkpoint.ckpt._CHUNK_BYTES", "lifetime.drift.SALT_NU",
    "lifetime.drift.SALT_READ", "lifetime.drift.SALT_PROG",
    "lifetime.drift.SALT_VERIFY", "lifetime.gdc.GDC_CHUNKS",
    "lifetime.gdc.SALT_REF", "lifetime.gdc._REF_SEED",
])
def test_format_constants_match_reference(name):
    mod, const = name.rsplit(".", 1)
    ref = getattr(importlib.import_module("repro." + mod), const)
    port = getattr(importlib.import_module("repro_torch." + mod), const)
    assert np.array_equal(np.asarray(port, np.int64), np.asarray(ref, np.int64))


def test_rule_tables_and_policy_tags_match_reference():
    from repro.configs.base import DIGITAL_PATH_PATTERNS
    from repro.core import plan as jplan
    from repro.core.tile import TileConfig as JTile
    from repro.distributed import sharding as jshd
    from repro_torch import api
    from repro_torch.core import plan
    from repro_torch.core.tile import TileConfig
    from repro_torch.distributed import sharding

    assert sharding.PARAM_RULES == jshd.PARAM_RULES
    assert api.DIGITAL_PATH_PATTERNS == DIGITAL_PATH_PATTERNS
    for path, nd in [("l0/attn/wq", 2), ("fc1/w", 2), ("w", 2), ("moe/wi", 3),
                     ("blocks/body/mlp/wo", 3), ("x/b", 1), ("s", 0)]:
        assert sharding.rule_template(path, nd) == jshd.rule_template(path, nd)
        assert sharding.template_tag(sharding.rule_template(path, nd)) \
            == jshd.template_tag(jshd.rule_template(path, nd))
    # unnamed policies hash their config into the same tag in both packages
    for kw in ({}, dict(algorithm="rider", lr_p=0.3, bl=4)):
        assert plan.TilePolicy(TileConfig(**kw)).tag \
            == jplan.TilePolicy(JTile(**kw)).tag
    # plan matching: first match wins, globs, regexes, the rank guard
    tp = api.lm_plan(("re:attn/(wq|wk)$", "digital"),
                     ("**/mlp/*", api.ECRAM_ERIDER), ("**", api.RERAM_OM_RIDER))
    jp = jplan.AnalogPlan.of(
        *[(f"re:(?i){p}", jplan.DIGITAL) for p in DIGITAL_PATH_PATTERNS],
        ("re:attn/(wq|wk)$", "digital"),
        ("**/mlp/*", jplan.TilePolicy.of("erider", "ecram", name="ecram-erider")),
        ("**", jplan.TilePolicy.of("rider", "reram_om", name="reram-om-rider")))
    leaf = torch.zeros(4, 4)
    for path in ("l0/attn/wq", "l0/attn/wo", "l0/mlp/wi", "embed", "l0/ln"):
        assert tp.policy_for(path, leaf).name == jp.policy_for(path, leaf).name
    assert tp.policy_for("l0/ln", torch.zeros(4)).is_digital
    # the CLI spec parser builds the same plan
    from repro.api import plan_from_spec as jspec
    tspec = api.plan_from_spec("attn=rider, **=erider",
                               lambda a: TileConfig(algorithm=a))
    jplan_ = jspec("attn=rider, **=erider", lambda a: JTile(algorithm=a))
    for path in ("l0/attn/wq", "l0/mlp/wi", "embed/table"):
        assert tspec.policy_for(path, leaf).tag == jplan_.policy_for(path, leaf).tag


def test_serve_defaults_table_matches_reference():
    from repro.configs import get_config as jget
    from repro.configs.serving import _FAMILY_DEFAULTS as JFAM
    from repro.configs.serving import serve_defaults as jdefaults
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.serving import _FAMILY_DEFAULTS, serve_defaults

    assert {k: dataclasses.asdict(v) for k, v in _FAMILY_DEFAULTS.items()} \
        == {k: dataclasses.asdict(v) for k, v in JFAM.items()}
    for arch in ARCHS:
        assert dataclasses.asdict(serve_defaults(get_config(arch))) \
            == dataclasses.asdict(jdefaults(jget(arch)))


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
