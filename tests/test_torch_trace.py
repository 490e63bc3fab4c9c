"""The port's spans on the training path (``repro_torch.trace``).

Under ``torch.profiler``, on the CPU: every ``train/*`` phase opens once a
step inside ``train/step``; ``model/attn``, ``model/mlp`` and
``model/ssm`` open once a layer in the forward and again in ``cfg.remat``'s
recompute; ``model/head_loss`` once a step; the backward's
``evaluate_function`` events link, through ``(fwd_thread_id,
sequence_nr)``, to forward ops inside the ``model/*`` spans. With no
profiler running a span dispatches nothing: an ``OpTrace`` of a step
records the same operations with the spans as with each span replaced by
a plain no-op.
"""
from __future__ import annotations

import contextlib
import sys
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import prng, trace
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.roofline.op_cost import OpTrace

PHASES = ("train/begin", "train/merge", "train/fwd_bwd", "train/digital",
          "train/update")
EVALUATE = "autograd::engine::evaluate_function"


def _lm_step(arch):
    """(donated step, state, batch) of the smoke ``arch`` on the CPU."""
    cfg = get_config(arch, smoke=True)
    model = LM(cfg)
    params = model.init(prng.PRNGKey(0), device="cpu")
    trainer = train.make_trainer(model, "erider", True, 10)
    state = trainer.init(prng.PRNGKey(1), params)
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    return cfg, trainer.jit_step(), state, {"tokens": toks[:, :-1],
                                           "labels": toks[:, 1:]}


def _profiled(arch, steps):
    cfg, step, state, batch = _lm_step(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
    events = [(e.name(), e.start_thread_id(), e.start_ns(),
               e.start_ns() + e.duration_ns(), e.sequence_nr(),
               e.fwd_thread_id())
              for e in prof.profiler.kineto_results.events()]
    return cfg, sorted(events, key=lambda e: e[2])


def _inside(inner, outer):
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def _named(events, name):
    return [e for e in events if e[0] == name]


@pytest.fixture(scope="module")
def qwen2():
    return _profiled("qwen2-0.5b", steps=2)


def test_phases_open_once_a_step_inside_the_step(qwen2):
    _, events = qwen2
    steps = _named(events, "train/step")
    assert len(steps) == 2
    for s in steps:
        for name in PHASES:
            assert len([e for e in _named(events, name) if _inside(e, s)]) == 1
    for name in PHASES:
        assert len(_named(events, name)) == 2
    # the phases run in order and do not overlap
    for s in steps:
        ph = [e for e in events if e[0] in PHASES and _inside(e, s)]
        assert [e[0] for e in ph] == list(PHASES)
        assert all(a[3] <= b[2] for a, b in zip(ph, ph[1:]))


def test_model_spans_open_in_forward_and_recompute(qwen2):
    cfg, events = qwen2
    assert cfg.remat and cfg.pattern == ("attn",)
    counts = Counter(e[0] for e in events if e[0].startswith("model/"))
    assert counts == {"model/attn": 2 * 2 * cfg.n_layers,
                      "model/mlp": 2 * 2 * cfg.n_layers,
                      "model/head_loss": 2}
    evaluate = [e for e in events if e[0].startswith(EVALUATE)]
    for fb in _named(events, "train/fwd_bwd"):
        attn = [e for e in _named(events, "model/attn") if _inside(e, fb)]
        # the recompute runs inside a backward node, on the thread that
        # runs backward (this one, on the CPU)
        again = [e for e in attn if any(_inside(e, ev) for ev in evaluate)]
        assert len(attn) == 2 * cfg.n_layers
        assert len(again) == cfg.n_layers
    for e in _named(events, "model/head_loss"):
        assert any(_inside(e, fb) for fb in _named(events, "train/fwd_bwd"))


def _linked_spans(events):
    """{model span: backward nodes whose forward op lies inside it}."""
    spans = [e for e in events if e[0].startswith("model/")]
    forward = {}
    for e in events:
        if e[4] >= 0 and not e[5]:
            # the last forward op to record the number (a backward node's
            # own events carry it too, and the forward's thread)
            forward[(e[1], e[4])] = e
    out = Counter()
    for ev in events:
        if ev[0].startswith(EVALUATE) and ev[4] >= 0:
            op = forward.get((ev[5], ev[4]))
            for sp in spans:
                if op is not None and _inside(op, sp):
                    out[sp[0]] += 1
    return out


def test_backward_links_to_forward_ops_in_model_spans(qwen2):
    linked = _linked_spans(qwen2[1])
    assert {"model/attn", "model/mlp", "model/head_loss"} <= set(linked)


def test_ssm_spans_in_mamba2():
    cfg, events = _profiled("mamba2-2.7b", steps=1)
    assert cfg.remat and set(cfg.pattern) == {"ssm"}
    counts = Counter(e[0] for e in events if e[0].startswith("model/"))
    assert counts == {"model/ssm": 2 * cfg.n_layers, "model/head_loss": 1}
    assert "model/ssm" in _linked_spans(events)
    for name in PHASES:
        assert len(_named(events, name)) == 1


def _op_names(step, state, batch):
    with OpTrace() as tr:
        step(state, batch)
    return [r.name for r in tr.records]


def test_spans_dispatch_nothing_without_a_profiler(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    _, step, state, batch = _lm_step("qwen2-0.5b")
    with_spans = _op_names(step, state, batch)
    assert not [n for n in with_spans if "record_function" in n]

    def plain(name, args=None):
        return contextlib.nullcontext()

    users = [m for name, m in sys.modules.items()
             if name.startswith("repro_torch.")
             and getattr(m, "span", None) is trace.span]
    assert len(users) >= 5          # trainer, prng, blocks, lm, pipeline
    for m in users:
        monkeypatch.setattr(m, "span", plain)
    _, step, state, batch = _lm_step("qwen2-0.5b")
    assert _op_names(step, state, batch) == with_spans
    # the same span under a profiler is an op of the dispatcher
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]), OpTrace() as tr:
        with trace.span("train/step", lambda: "0"):
            pass
    assert [r.name for r in tr.records if "record_function" in r.name]
