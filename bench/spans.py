"""The program's own spans in the traced window: device time by step phase
and by model span, and device idle put down to the host key chain.

The port opens named spans on its training path (``repro_torch.trace``):
the phases ``train/begin``, ``train/merge``, ``train/fwd_bwd``,
``train/digital`` and ``train/update`` inside ``train/step``; the
``model/*`` spans around a layer's mixer and MLP and the head and loss;
``prng/split`` and ``prng/fold_in`` around the host key chain. This module
reduces the same profiler events ``bench/trace.py`` walks:

1. Each device op is mapped to its launch: its correlation id names the
   CUDA runtime call that launched it, which gives the host time of the
   launch; the host thread is that of the program's op that made the call
   (the runtime call's linked op). Without a runtime event, the op the
   device op is linked to stands for the launch.
2. A ``train/*`` phase owns the op if the launch lies inside it. Backward
   kernels launched from the autograd thread fall inside ``train/fwd_bwd``
   in time, so they count there.
3. A ``model/*`` span owns the op if it is open on the launching thread at
   the launch (the forward, and ``cfg.remat``'s recompute). Otherwise the
   innermost ``autograd::engine::evaluate_function`` open there names the
   backward node: its ``(fwd_thread_id, sequence_nr)`` is that of the
   forward op that made the node, and the ``model/*`` span open at that
   op owns the op.
4. The key chain's idle time is the overlap of the device's idle gaps
   (within the traced steps) with the union of the ``prng/*`` spans on the
   thread that runs the steps.

Every time is the union of the owned ops' intervals, in seconds over the
traced steps. A trace with no program spans (a program that has none)
reduces to empty tables and ``keychain_idle_s`` None, and raises nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from .trace import union_seconds

PHASES = ("train/begin", "train/merge", "train/fwd_bwd", "train/digital",
          "train/update")
STEP = "train/step"
EVALUATE = "autograd::engine::evaluate_function"


class Ev(NamedTuple):
    """One profiler event. ``kind``: "device" (a kernel, copy or fill),
    "runtime" (a CUDA runtime or driver call) or "op" (the program's host
    op or span). ``corr``: the event's correlation id; ``linked``: that of
    the op it belongs to; ``seq`` and ``fwd_tid``: an autograd node's
    sequence number and the thread of its forward."""
    kind: str
    name: str
    tid: int
    start: int
    end: int
    corr: int = 0
    linked: int = 0
    seq: int = -1
    fwd_tid: int = 0


def from_kineto(events) -> List[Ev]:
    """``Ev`` tuples of ``torch.profiler``'s kineto events."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        cuda = e.device_type() == DeviceType.CUDA
        if cuda and e.is_user_annotation():
            continue  # a host span's shadow on the device's timeline
        if cuda:
            kind = "device"
        elif e.linked_correlation_id() > 0:
            # a host event linked to a program op: a runtime call, as
            # ``torch.autograd.profiler`` tells them apart
            kind = "runtime"
        else:
            kind = "op"
        s = e.start_ns()
        out.append(Ev(kind, e.name(), e.start_thread_id(), s,
                      s + e.duration_ns(), e.correlation_id(),
                      e.linked_correlation_id(), e.sequence_nr(),
                      e.fwd_thread_id()))
    return out


def union_s(intervals) -> float:
    """Seconds covered by ``intervals`` [(start_ns, end_ns)]."""
    return union_seconds(intervals)[0]


def _merged(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_s(a, b) -> float:
    """Seconds in which both lists of disjoint sorted intervals lie."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total * 1e-9


class Nest:
    """Properly nested intervals of one thread, for the innermost one open
    at a time."""

    def __init__(self, items):
        """``items``: [(start, end, value)]."""
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.items]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        """The value of the innermost interval open at ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return self.items[i][2] if i >= 0 else None


def _by_thread(evs) -> Dict[int, List[Ev]]:
    out: Dict[int, List[Ev]] = defaultdict(list)
    for e in evs:
        out[e.tid].append(e)
    return out


def launches(evs: List[Ev]) -> Dict[int, Tuple[int, int]]:
    """{index of a device op in ``evs``: (host thread, host time) of its
    launch}, for the device ops whose launch is found."""
    ops = {e.corr: e for e in evs if e.kind == "op"}
    runtime = {e.corr: e for e in evs if e.kind == "runtime"}
    out = {}
    for i, e in enumerate(evs):
        if e.kind != "device":
            continue
        r = runtime.get(e.corr)
        op = ops.get(r.linked if r is not None else e.linked)
        if r is not None:
            out[i] = (op.tid if op is not None else r.tid, r.start)
        elif op is not None:
            out[i] = (op.tid, op.start)
    return out


def _model_owner(tid: int, t: int, model: Dict[int, Nest],
                 evaluate: Dict[int, Nest], forward: Dict[Tuple[int, int], int]
                 ) -> Optional[str]:
    """The ``model/*`` span that owns a launch at ``t`` on thread ``tid``."""
    name = model[tid].at(t) if tid in model else None
    if name is None and tid in evaluate:
        node = evaluate[tid].at(t)
        t_fwd = forward.get(node)
        if t_fwd is not None and node[0] in model:
            name = model[node[0]].at(t_fwd)
    return name


def reduce(events, steps: int) -> Dict:
    """The spans' tables of one traced window of ``steps`` steps.
    ``events``: ``torch.profiler``'s kineto events, or ``Ev`` tuples."""
    evs = list(events)
    if evs and not isinstance(evs[0], Ev):
        evs = from_kineto(evs)
    device = [(i, e) for i, e in enumerate(evs) if e.kind == "device"]
    ops = [e for e in evs if e.kind == "op"]
    launch = launches(evs)
    step_spans = [e for e in ops if e.name == STEP]
    main = {e.tid for e in step_spans}
    phases = Nest([(e.start, e.end, e.name) for e in ops
                   if e.name in PHASES])
    threads = _by_thread(ops)
    model = {tid: Nest([(e.start, e.end, e.name) for e in es
                        if e.name.startswith("model/")])
             for tid, es in threads.items()}
    evaluate = {tid: Nest([(e.start, e.end, (e.fwd_tid, e.seq)) for e in es
                           if e.name.startswith(EVALUATE)])
                for tid, es in threads.items()}
    # (thread, sequence number) -> the start of the forward op that made
    # the node: the last forward op to record that number on that thread
    # (a backward node's own events carry its number and the forward's
    # thread)
    forward: Dict[Tuple[int, int], int] = {}
    for e in ops:
        if e.seq >= 0 and not e.fwd_tid:
            k = (e.tid, e.seq)
            if forward.get(k, -1) < e.start:
                forward[k] = e.start

    by_phase: Dict[str, list] = defaultdict(list)
    by_model: Dict[str, list] = defaultdict(list)
    mapped, in_phase, fwd_bwd_model = [], [], []
    for i, e in device:
        at = launch.get(i)
        if at is None:
            continue
        iv = (e.start, e.end)
        mapped.append(iv)
        tid, t = at
        phase = phases.at(t)
        if phase is not None:
            by_phase[phase].append(iv)
            in_phase.append(iv)
        name = _model_owner(tid, t, model, evaluate, forward)
        if name is not None:
            by_model[name].append(iv)
            if phase == "train/fwd_bwd":
                fwd_bwd_model.append(iv)

    intervals = [(e.start, e.end) for _, e in device]
    busy_s, gaps = union_seconds(intervals)
    if intervals and step_spans:
        # the idle time before the first device op and after the last,
        # within the traced steps
        lo = min(e.start for e in step_spans)
        hi = max(e.end for e in step_spans)
        first, last = min(intervals)[0], max(e for _, e in intervals)
        gaps += [g for g in ((lo, first), (last, hi)) if g[1] > g[0]]
    chain = [(e.start, e.end) for e in ops
             if e.name.startswith("prng/") and e.tid in main]
    return {
        "steps": steps,
        "busy_s": busy_s,
        "mapped_s": union_s(mapped),
        "phases_s": union_s(in_phase),
        "phase_s": {k: union_s(v) for k, v in sorted(by_phase.items())},
        "model_s": {k: union_s(v) for k, v in sorted(by_model.items())},
        "fwd_bwd_model_s": union_s(fwd_bwd_model),
        "keychain_idle_s": (overlap_s(sorted(gaps), _merged(chain))
                            if chain else None),
    }


# the per-layer metrics these tables give, in milliseconds a step:
# name -> (table, key); ``keychain_idle_ms`` reads the scalar
METRICS = {
    "fwd_bwd_ms": ("phase_s", "train/fwd_bwd"),
    "update_ms": ("phase_s", "train/update"),
    "attention_ms": ("model_s", "model/attn"),
    "ssm_ms": ("model_s", "model/ssm"),
    "head_loss_ms": ("model_s", "model/head_loss"),
    "keychain_idle_ms": ("keychain_idle_s", None),
}


def metrics(sp: Dict) -> Dict[str, float]:
    """{metric: ms a step} of a ``reduce`` result; a metric whose span the
    trace does not hold is left out."""
    out = {}
    for name, (table, key) in METRICS.items():
        value = sp[table] if key is None else sp[table].get(key)
        if value is not None and sp["steps"]:
            out[name] = 1e3 * value / sp["steps"]
    return out


def coverage(sp: Dict) -> Dict[str, Optional[float]]:
    """Shares, in %: of the device's busy time, the part whose launch was
    found (``mapped``) and the part the ``train/*`` phases own
    (``phases``); of ``train/fwd_bwd``'s device time, the part the
    ``model/*`` spans own (``model_of_fwd_bwd``)."""
    def share(a, b):
        return 100.0 * a / b if b else None
    return {"mapped": share(sp["mapped_s"], sp["busy_s"]),
            "phases": share(sp["phases_s"], sp["busy_s"]),
            "model_of_fwd_bwd": share(sp["fwd_bwd_model_s"],
                                      sp["phase_s"].get("train/fwd_bwd", 0))}
