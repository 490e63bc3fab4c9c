"""The traced window: ``torch.profiler`` over a few steps, reduced to what
the per-layer readers and the ``breakdown`` take.

Device time is the union of the intervals in which any device operation
(kernel, copy or fill) ran, so operations that overlap on two streams
count once. A gap in that union is idle device time; each of the longest
gaps is put down to the innermost host operation open at its middle (a
span of the benchmark's own, ``bench/...``, or an op of the program).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10
LABELLED_GAPS = 4000
NAME_CHARS = 160


def union_seconds(intervals: List[Tuple[int, int]]) -> Tuple[float, list]:
    """(seconds covered, gaps [(start, end)]) of ``intervals`` in ns."""
    busy, gaps = 0, []
    end = None
    for s, e in sorted(intervals):
        if end is None:
            busy += e - s
            end = e
        elif s > end:
            gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-9, gaps


def _innermost(cpu, starts, t) -> str:
    """The host op open at ``t`` with the latest start, or "host idle"."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 2000, -1), -1):
        name, s, e = cpu[j]
        if e >= t:
            return name
    return "host: no op open"


def reduce(kernels, cpu, window_s: float, steps: int) -> Dict:
    """``kernels``: device ops [(name, start_ns, end_ns)]; ``cpu``: host ops
    [(name, start_ns, end_ns)]."""
    busy_s, gaps = union_seconds([(s, e) for _, s, e in kernels])
    # the idle time before the first device op and after the last, within
    # the benchmark's own spans of the traced steps
    spans = [(s, e) for n, s, e in cpu if n.startswith("bench/")]
    if spans and kernels:
        first = min(s for _, s, _ in kernels)
        last = max(e for _, _, e in kernels)
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        gaps += [g for g in ((lo, first), (last, hi)) if g[1] > g[0]]
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in kernels:
        by_name[name] += (e - s) * 1e-9
    cpu = sorted(cpu, key=lambda c: c[1])
    starts = [c[1] for c in cpu]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        idle[_innermost(cpu, starts, (s + e) // 2)] += (e - s) * 1e-9
    launches = sum(1 for n, _, _ in kernels
                   if not n.startswith(("Memcpy", "Memset")))

    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"steps": steps, "window_s": window_s, "busy_s": busy_s,
            "launches": launches, "kernel_s": dict(by_name),
            "device_ops": top(by_name), "idle_gaps": top(idle)}


class Recorder:
    """``with Recorder(cuda):`` profiles the steps run inside it."""

    def __init__(self, cuda: bool):
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.window_s = 0.0

    def __enter__(self):
        self.prof.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t
        return self.prof.__exit__(*exc)

    def summary(self, steps: int) -> Dict:
        kernels, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                # a host span's shadow on the device's timeline ran nothing
                if not e.is_user_annotation():
                    kernels.append(rec)
            elif e.device_type() == DeviceType.CPU:
                cpu.append(rec)
        return reduce(kernels, cpu, self.window_s, steps)
