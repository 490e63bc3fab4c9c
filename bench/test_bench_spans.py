"""The reduction of the program's spans (``bench/spans.py``), on synthetic
events: a device op goes to the phase open at its launch, found through
its correlation id; a backward op on the autograd thread to the forward's
``model/*`` span through ``(fwd_thread_id, sequence_nr)``; a recompute op
to the span opened again on its own thread; idle to the key chain only
where a gap meets a ``prng/*`` span of the steps' thread. A trace with no
program spans gives no metric, and the report's recorder keeps every key
of the driver's summary as it was.
"""
from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from bench import span_report, spans, trace
from bench.spans import Ev

MAIN, AUTOGRAD, SYSTEM = 1, 2, 90001


def op(name, start, end, corr, tid=MAIN, seq=-1, fwd_tid=0):
    return Ev("op", name, tid, start, end, corr, 0, seq, fwd_tid)


def launch(linked, start, end, cupti, kernel_start, kernel_end):
    """An op's launch: the runtime call and the kernel it launched."""
    return [Ev("runtime", "cudaLaunchKernel", SYSTEM, start, end, cupti,
               linked),
            Ev("device", f"kernel{cupti}", 7, kernel_start, kernel_end, cupti,
               linked)]


def step_events():
    """One step: begin, fwd_bwd (a forward in ``model/attn``, its
    backward on the autograd thread, a recompute there), update."""
    return [
        op("train/step", 0, 1000, 1),
        op("train/begin", 10, 100, 2),
        op("aten::mul", 20, 40, 3),
        # launched in train/begin, it runs while fwd_bwd is open
        *launch(3, 25, 30, 501, 50, 150),
        op("train/fwd_bwd", 100, 800, 4),
        op("model/attn", 110, 200, 5),
        op("aten::mm", 120, 150, 6, seq=7),
        *launch(6, 125, 130, 502, 150, 170),
        op("aten::add", 210, 220, 7, seq=8),      # outside every span
        *launch(7, 212, 214, 503, 170, 180),
        # backward of the mm, on the autograd thread
        op("autograd::engine::evaluate_function: MmBackward0", 500, 560, 8,
           tid=AUTOGRAD, seq=7, fwd_tid=MAIN),
        op("aten::mm", 510, 550, 9, tid=AUTOGRAD),
        *launch(9, 515, 520, 504, 600, 700),
        # backward of the add, whose forward lies in no span
        op("autograd::engine::evaluate_function: AddBackward0", 560, 600,
           10, tid=AUTOGRAD, seq=8, fwd_tid=MAIN),
        op("aten::neg", 565, 570, 11, tid=AUTOGRAD),
        *launch(11, 566, 568, 505, 700, 720),
        # the recompute: model/attn opened again inside a backward node
        # whose forward op (the add) lies in no span
        op("autograd::engine::evaluate_function: AddBackward0", 600, 700,
           12, tid=AUTOGRAD, seq=8, fwd_tid=MAIN),
        op("model/attn", 610, 690, 13, tid=AUTOGRAD),
        op("aten::mm", 620, 640, 14, tid=AUTOGRAD),
        *launch(14, 625, 630, 506, 720, 760),
        op("train/update", 800, 990, 15),
        op("aten::copy_", 810, 820, 16),
        *launch(16, 812, 814, 507, 820, 900),
    ]


def test_kernel_goes_to_the_phase_open_at_its_launch():
    sp = spans.reduce(step_events(), steps=1)
    # kernel 501 runs at 50-150 but was launched at 25, in train/begin
    assert sp["phase_s"]["train/begin"] == pytest.approx(100e-9)
    # 150-180 and 600-760
    assert sp["phase_s"]["train/fwd_bwd"] == pytest.approx(190e-9)
    assert sp["phase_s"]["train/update"] == pytest.approx(80e-9)
    assert sp["busy_s"] == pytest.approx(100e-9 + 30e-9 + 160e-9 + 80e-9)
    assert sp["mapped_s"] == sp["busy_s"] == sp["phases_s"]
    # a kernel found through its op alone (no runtime event), and one
    # found through nothing
    evs = step_events() + [
        Ev("device", "orphan", 7, 950, 960, 999, 16),
        Ev("device", "lost", 7, 970, 980, 998, 997)]
    sp2 = spans.reduce(evs, steps=1)
    assert sp2["phase_s"]["train/update"] == pytest.approx(90e-9)
    assert sp2["busy_s"] - sp2["mapped_s"] == pytest.approx(10e-9)


def test_backward_kernel_goes_to_the_forward_span():
    sp = spans.reduce(step_events(), steps=1)
    # forward 150-170, backward 600-700, recompute 720-760
    assert sp["model_s"] == {"model/attn": pytest.approx(160e-9)}
    # the add's forward (170-180) and backward (700-720) lie in no span
    assert sp["fwd_bwd_model_s"] == pytest.approx(160e-9)
    cov = spans.coverage(sp)
    assert cov["model_of_fwd_bwd"] == pytest.approx(100 * 160 / 190)
    assert cov["phases"] == cov["mapped"] == pytest.approx(100.0)


def test_backward_on_the_forward_thread():
    """Backward on the thread of the forward, as on the CPU: the backward
    nodes' own events carry the forward op's sequence number too."""
    evs = [e._replace(tid=MAIN) if e.tid == AUTOGRAD else e
           for e in step_events()]
    evs += [op("MmBackward0", 505, 555, 20, seq=7, fwd_tid=MAIN),
            op("AddBackward0", 562, 598, 21, seq=8, fwd_tid=MAIN)]
    sp = spans.reduce(evs, steps=1)
    assert sp["model_s"] == {"model/attn": pytest.approx(160e-9)}


def test_recompute_kernel_goes_to_the_reopened_span():
    evs = [e for e in step_events() if e.corr not in (502, 504)]
    sp = spans.reduce(evs, steps=1)
    assert sp["model_s"]["model/attn"] == pytest.approx(40e-9)   # 720-760
    # without the reopened span the same kernel has no model owner
    evs = [e for e in evs if not (e.name == "model/attn" and e.tid == AUTOGRAD)]
    assert "model/attn" not in spans.reduce(evs, steps=1)["model_s"]


def test_keychain_idle_counts_gaps_under_prng_spans_only():
    device = [Ev("device", "k", 7, 50, 150, 1), Ev("device", "k", 7, 600, 700, 2)]
    steps = [op("train/step", 0, 800, 10)]
    chain = [
        op("prng/split", 0, 10, 11),              # leading gap 0-50: 10
        op("prng/split", 140, 200, 12),           # gap 150-600: 50
        op("prng/fold_in", 160, 170, 13),         # nested, counted once
        op("prng/fold_in", 300, 350, 14, tid=AUTOGRAD),  # not the steps' thread
        op("prng/split", 620, 640, 15),           # the device is busy
    ]
    sp = spans.reduce(device + steps + chain, steps=2)
    assert sp["keychain_idle_s"] == pytest.approx(60e-9)
    assert spans.metrics(sp)["keychain_idle_ms"] == pytest.approx(30e-6)
    # a trailing gap to the step's end counts too
    sp = spans.reduce(device + steps + [op("prng/split", 750, 790, 16)], 1)
    assert sp["keychain_idle_s"] == pytest.approx(40e-9)


def test_metrics_are_absent_without_the_spans():
    sp = spans.reduce(step_events(), steps=2)
    got = spans.metrics(sp)
    assert got["fwd_bwd_ms"] == pytest.approx(1e3 * 190e-9 / 2)
    assert got["update_ms"] == pytest.approx(1e3 * 80e-9 / 2)
    assert got["attention_ms"] == pytest.approx(1e3 * 160e-9 / 2)
    assert not {"ssm_ms", "head_loss_ms", "keychain_idle_ms"} & set(got)
    # a program without spans: kernels, launches and ops only
    bare = [e for e in step_events()
            if e.kind != "op" or e.name.startswith(("aten::", "autograd::"))]
    sp = spans.reduce(bare, steps=2)
    assert spans.metrics(sp) == {}
    assert sp["keychain_idle_s"] is None
    assert sp["mapped_s"] == sp["busy_s"] and sp["phases_s"] == 0.0
    assert spans.coverage(sp)["model_of_fwd_bwd"] is None
    assert spans.metrics(spans.reduce([], steps=2)) == {}


class _Kineto:
    """The part of a profiler event the summaries read."""

    def __init__(self, ev: Ev):
        self.ev = ev

    def name(self):
        return self.ev.name

    def start_ns(self):
        return self.ev.start

    def duration_ns(self):
        return self.ev.end - self.ev.start

    def device_type(self):
        return DeviceType.CUDA if self.ev.kind == "device" else DeviceType.CPU

    def is_user_annotation(self):
        return self.ev.name.startswith(("train/", "model/", "prng/"))

    def start_thread_id(self):
        return self.ev.tid

    def correlation_id(self):
        return self.ev.corr

    def linked_correlation_id(self):
        return self.ev.linked

    def sequence_nr(self):
        return self.ev.seq

    def fwd_thread_id(self):
        return self.ev.fwd_tid


class _Prof:
    def __init__(self, events):
        class Results:
            def events(self):
                return events

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


def test_report_keeps_every_key_of_the_summary():
    events = [_Kineto(e) for e in step_events()]
    # a device-side shadow of a host span: dropped by both
    events.append(_Kineto(Ev("device", "train/step", 7, 0, 1000)))
    events[-1].is_user_annotation = lambda: True
    plain = trace.Recorder(False)
    plain.prof, plain.window_s = _Prof(events), 2e-6
    extended = span_report.recorder_with_spans()(False)
    extended.prof, extended.window_s = _Prof(events), 2e-6
    base, ext = plain.summary(3), extended.summary(3)
    assert set(ext) == set(base) | {"spans"}
    assert {k: ext[k] for k in base} == base
    assert ext["spans"] == spans.reduce(step_events(), 3)
    assert base["launches"] == 7
