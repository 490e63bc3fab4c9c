"""Continuous-batching analog serving engine (port of ``repro.serving``).

Layers (each independently testable):
  kv_pages   — fixed-size KV page accounting: PageAllocator (alloc/free per
               request, leak/double-free checked) + page-table index math.
  scheduler  — per-step admission of waiting prefills into freed decode
               lanes (FIFO, head-of-line page budgeting, no starvation).
  sampling   — sample_greedy / sample_topk + FeedBuilder shared by every
               serve driver.
  telemetry  — per-request TTFT/TPOT, p50/p99 percentiles, structured JSON
               logging and the shutdown run-artifact manifest.
  schema     — checked-in schemas for log lines + manifest, dependency-free
               validator (the reference's tables).
  engine     — ServeEngine: drives prefill/decode disaggregation over the
               paged caches in models/lm.py and serves the effective
               weights of an analog checkpoint (aged, drift-compensated).
"""
from .engine import EngineConfig, ServeEngine, ServeRequest, load_effective_params  # noqa: F401
from .kv_pages import PageAllocator, needed_pages  # noqa: F401
from .sampling import FeedBuilder, lane_keys, sample_greedy, sample_topk  # noqa: F401
from .scheduler import ContinuousScheduler  # noqa: F401
from .telemetry import Telemetry  # noqa: F401
