"""Serving observability: per-request latency, JSON logs, run manifest.

Port of the JAX package's ``serving/telemetry.py`` (pure Python).

Every request gets a timeline (submitted / admitted / first token / finished)
from which TTFT (time to first token), TPOT (time per output token after the
first) and end-to-end latency derive; ``summarize`` reduces a population to
p50/p99/mean/max with numpy-compatible linear-interpolation percentiles.

All wall-clock reads go through an injectable ``clock`` so tests drive
synthetic timelines deterministically.  Every emitted log line and the final
manifest are validated against ``serving.schema`` at emission time — schema
drift fails the producer, not just the consumer.
"""
from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Any, Callable, Dict, IO, List, Optional

from . import schema


# ---------------------------------------------------------------------------
# percentiles (numpy 'linear' interpolation, dependency-free)
# ---------------------------------------------------------------------------


def percentile(values: List[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation between closest
    ranks — matches ``numpy.percentile(..., method='linear')``."""
    if not values:
        raise ValueError("percentile of empty population")
    xs = sorted(values)
    rank = (len(xs) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def summarize(values: List[float]) -> Dict[str, float]:
    return {
        "p50": percentile(values, 50.0),
        "p99": percentile(values, 99.0),
        "mean": sum(values) / len(values),
        "max": max(values),
    }


# ---------------------------------------------------------------------------
# per-request timelines
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestTimeline:
    request_id: str
    prompt_len: int = 0
    submitted_s: float = 0.0
    admitted_s: float = 0.0
    first_token_s: float = 0.0
    last_token_s: float = 0.0
    finished_s: float = 0.0
    n_tokens: int = 0

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.submitted_s

    @property
    def tpot_s(self) -> float:
        """Seconds per output token after the first (0 for 1-token runs)."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.finished_s - self.first_token_s) / (self.n_tokens - 1)

    @property
    def e2e_s(self) -> float:
        return self.finished_s - self.submitted_s


class JsonLogger:
    """Schema-validated structured JSON logging (one object per line)."""

    def __init__(self, sink: Optional[IO[str]] = None):
        self.sink = sink
        self.lines: List[Dict[str, Any]] = []

    def emit(self, line: Dict[str, Any]) -> None:
        schema.validate_log_line(line)
        self.lines.append(line)
        if self.sink is not None:
            self.sink.write(json.dumps(line, sort_keys=True) + "\n")
            self.sink.flush()


class Telemetry:
    """Collects request timelines and engine counters, emits log lines, and
    writes the run-artifact manifest at shutdown."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 log_sink: Optional[IO[str]] = None, log_path: str = ""):
        self._t0 = clock()
        self._clock = clock
        self.log_path = log_path
        self._own_sink = None
        if log_sink is None and log_path:
            self._own_sink = log_sink = open(log_path, "w")
        self.logger = JsonLogger(log_sink)
        self.timelines: Dict[str, RequestTimeline] = {}
        self.steps = 0
        self.prefills = 0            # completed request prefills
        self.prefill_batches = 0     # bucketed prefill dispatches
        self.chunks = 0              # prefill segments (chunked or whole)
        self.retraces = 0            # distinct (len, batch) bucket signatures
        self.gaps: List[float] = []  # pooled inter-token intervals (jitter)
        self.run_id = uuid.uuid4().hex[:12]

    def now(self) -> float:
        return self._clock() - self._t0

    # ------------------------------------------------------------- events
    def request_submitted(self, request_id: str, prompt_len: int,
                          max_new_tokens: int, arrival_step: int = 0) -> None:
        t = self.now()
        self.timelines[request_id] = RequestTimeline(
            request_id, prompt_len=prompt_len, submitted_s=t)
        self.logger.emit({"ts": t, "event": "request_submitted",
                          "request_id": request_id, "prompt_len": prompt_len,
                          "max_new_tokens": max_new_tokens,
                          "arrival_step": arrival_step})

    def request_admitted(self, request_id: str, lane: int, n_pages: int,
                         step: int, shared_pages: int = 0,
                         chunks: int = 1) -> None:
        t = self.now()
        self.timelines[request_id].admitted_s = t
        line = {"ts": t, "event": "request_admitted",
                "request_id": request_id, "lane": lane,
                "n_pages": n_pages, "step": step}
        if shared_pages or chunks > 1:
            line["shared_pages"] = shared_pages
            line["chunks"] = chunks
        self.logger.emit(line)

    def prefill_batch(self, step: int, bucket: int, batch: int) -> None:
        """One bucketed prefill dispatch: ``batch`` rows padded to length
        ``bucket`` ran through a single call."""
        self.logger.emit({"ts": self.now(), "event": "prefill_batch",
                          "step": step, "bucket": bucket, "batch": batch})

    def first_token(self, request_id: str) -> None:
        tl = self.timelines[request_id]
        tl.first_token_s = tl.last_token_s = self.now()
        tl.n_tokens = 1

    def token(self, request_id: str) -> None:
        tl = self.timelines[request_id]
        t = self.now()
        tl.n_tokens += 1
        self.gaps.append(t - tl.last_token_s)
        tl.last_token_s = t

    def request_finished(self, request_id: str, lane: int, step: int) -> None:
        tl = self.timelines[request_id]
        tl.finished_s = self.now()
        self.logger.emit({"ts": tl.finished_s, "event": "request_finished",
                          "request_id": request_id, "lane": lane,
                          "n_tokens": tl.n_tokens, "ttft_s": tl.ttft_s,
                          "tpot_s": tl.tpot_s, "e2e_s": tl.e2e_s,
                          "step": step})

    def engine_stats(self, step: int, active_lanes: int, waiting: int,
                     free_pages: int) -> None:
        self.logger.emit({"ts": self.now(), "event": "engine_stats",
                          "step": step, "active_lanes": active_lanes,
                          "waiting": waiting, "free_pages": free_pages})

    # ------------------------------------------------------------ summary
    def finished(self) -> List[RequestTimeline]:
        return [tl for tl in self.timelines.values() if tl.finished_s > 0]

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        done = self.finished()
        if not done:
            zero = {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
            return {"ttft": dict(zero), "tpot": dict(zero), "e2e": dict(zero)}
        out = {
            "ttft": summarize([tl.ttft_s for tl in done]),
            "tpot": summarize([tl.tpot_s for tl in done]),
            "e2e": summarize([tl.e2e_s for tl in done]),
        }
        # per-request TPOT averages away intra-request stalls; the pooled
        # inter-token intervals expose them (what chunked prefill shrinks)
        if self.gaps:
            out["gap"] = summarize(self.gaps)
        return out

    def generated_tokens(self) -> int:
        return sum(tl.n_tokens for tl in self.timelines.values())

    def run_summary(self, wall_s: float,
                    extras: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        toks = self.generated_tokens()
        line = {"ts": self.now(), "event": "run_summary",
                "requests": len(self.timelines), "generated_tokens": toks,
                "wall_s": wall_s,
                "tokens_per_s": toks / wall_s if wall_s > 0 else 0.0}
        if extras:
            line.update(extras)
        self.logger.emit(line)
        return line

    # ----------------------------------------------------------- manifest
    def build_manifest(self, *, arch: str, engine: Dict[str, Any],
                       checkpoint: Dict[str, Any], wall_s: float,
                       status: str = "completed",
                       lifetime: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        toks = self.generated_tokens()
        manifest = {
            "schema_version": schema.SCHEMA_VERSION,
            "kind": "serve_run_manifest",
            "run_id": self.run_id,
            "created_unix": time.time(),
            "arch": arch,
            "engine": engine,
            "checkpoint": checkpoint,
            "workload": {
                "requests": len(self.timelines),
                "prompt_tokens": sum(tl.prompt_len for tl in self.timelines.values()),
                "generated_tokens": toks,
            },
            "latency_s": self.latency_summary(),
            "throughput": {
                "tokens_per_s": toks / wall_s if wall_s > 0 else 0.0,
                "wall_s": wall_s,
                "steps": self.steps,
                "prefills": self.prefills,
                "prefill_batches": self.prefill_batches,
                "prefill_chunks": self.chunks,
                "retraces": self.retraces,
            },
            "artifacts": {"log": self.log_path or None},
            "status": status,
        }
        if lifetime is not None:
            # load_effective_params' report: age, GDC state, drift scales
            manifest["lifetime"] = lifetime
        schema.validate_manifest(manifest)
        return manifest

    def write_manifest(self, path: str, **kw) -> Dict[str, Any]:
        manifest = self.build_manifest(**kw)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
        return manifest

    def close(self) -> None:
        if self._own_sink is not None:
            self._own_sink.close()
            self._own_sink = None
