"""The port's model configs against the JAX package's.

* Every field of every ``CONFIG`` and ``SMOKE_CONFIG`` of the ten archs
  equals the reference's (``dtype`` compared by name), and so do the
  derived properties, ``param_count`` and ``active_param_count``: exact.
* ``SHAPES``, ``LAYER_KINDS``, ``DIGITAL_PATH_PATTERNS``,
  ``shape_applicable``, ``sub_quadratic`` and ``input_specs`` (shapes and
  dtypes of every input of every arch x shape cell): exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)


def _plain(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) or type(v).__name__ == "_ScalarMeta":
        return np.dtype(v).name
    return v


def _fields(cfg):
    return {f.name: _plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def test_registry_matches_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert list(configs.all_configs()) == list(jconfigs.all_configs())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts_match_reference(arch, smoke):
    got, want = configs.get_config(arch, smoke), jconfigs.get_config(arch, smoke)
    assert _fields(got) == _fields(want)
    assert isinstance(got.dtype, torch.dtype)
    for prop in ("layer_kinds", "is_encdec", "rnn_width", "d_inner",
                 "ssm_heads"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_schema_tables_match_reference():
    assert base.LAYER_KINDS == jbase.LAYER_KINDS
    assert base.DIGITAL_PATH_PATTERNS == jbase.DIGITAL_PATH_PATTERNS
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(AssertionError):
        base.ModelConfig(n_layers=3, n_periods=2)
    with pytest.raises(AssertionError):
        base.ModelConfig(pattern=("conv",))


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_and_input_specs_match_reference(arch):
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert base.sub_quadratic(got) == jbase.sub_quadratic(want)
    for shape in base.SHAPES:
        assert base.shape_applicable(got, shape) == \
            jbase.shape_applicable(want, shape)
        specs = base.input_specs(got, shape, device="cpu")
        jspecs = jbase.input_specs(want, shape)
        assert list(specs) == list(jspecs)
        for k, s in specs.items():
            assert s.shape == tuple(jspecs[k].shape), (shape, k)
            assert _plain(s.dtype) == np.dtype(jspecs[k].dtype).name
            assert s.device == torch.device("cpu")
