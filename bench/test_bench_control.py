"""The comparison that decides ``correct`` fails what it has to fail.

At a size the CPU holds (the port's smoke configurations), under each
cell's own limits (``bench/limits``):
  * the control, the plain reference computed in float8 e4m3, the
    precision below the configurations' bfloat16, is not correct;
  * the reference with half of each batch left out is not correct;
  * a whole run of the harness (``run.execute``, its look for a card
    skipped) with the timed path broken underneath, a step that returns
    its state unchanged or one that leaves out half the batch, comes out
    ``correct: false``, and the same run unbroken ``correct: true``.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch
from repro_torch.core.paths import tree_map
from repro_torch.core.trainer import AnalogTrainer

from bench import checks, run
from bench.control import readings
from bench.test_bench_reference import MIX, port_config, smoke_context

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
ARCH = {"qwen2-0.5b": ("qwen2-0.5b", 2), "mamba2-2.7b-l56": ("mamba2-2.7b", 3)}
CELLS = [(w["name"], *ARCH[w["config"]]) for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell,arch,layers", CELLS)
def test_control_and_half_batch_are_not_correct(cell, arch, layers):
    lim = checks.limits(cell)
    config = port_config(arch, layers, smoke=True)
    for seed in (1, 2, 3):
        r = readings(config, MIX, seed, "cpu")
        assert not checks.verdict(r["control"], lim), r
        assert not checks.verdict(r["half_batch"], lim), r


def _frozen(step):
    """A step that returns its state unchanged (its metrics from a copy)."""
    def frozen(state, batch):
        return state, step(tree_map(torch.clone, state), batch)[1]
    return frozen


def _half_batch(step):
    """A step that leaves out half the batch, the mean over the rest."""
    def half(state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})
    return half


@pytest.mark.parametrize("fault", [None, _frozen, _half_batch],
                         ids=["sound", "frozen", "half_batch"])
@pytest.mark.parametrize("cell,arch,layers", CELLS)
def test_broken_timed_path_is_not_correct(cell, arch, layers, fault,
                                          monkeypatch):
    if fault is not None:
        jit_step = AnalogTrainer.jit_step
        monkeypatch.setattr(AnalogTrainer, "jit_step",
                            lambda self, **kw: fault(jit_step(self, **kw)))
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    ctx = smoke_context(arch, layers, 2 ** 31 + 101, cell=w)
    ctx.t0 = time.perf_counter()
    line, _ = run.execute(ctx, SPEC)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
