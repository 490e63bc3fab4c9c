"""Fault-tolerance runtime: preemption handling, straggler monitoring,
checkpoint/restart orchestration.

A copy of the JAX package's ``distributed/fault.py`` (pure Python). Each
host runs it next to the train loop; ``launch/train.py`` uses the
preemption flag and the straggler monitor.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, List, Optional


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag.

    Usage:
      handler = PreemptionHandler(install=True)
      while training:
          ...
          if handler.should_stop: save_checkpoint(); break
    """

    def __init__(self, install: bool = True):
        self.should_stop = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handle)
                except ValueError:
                    pass  # not on main thread

    def _handle(self, signum, frame):
        self.should_stop = True

    def trigger(self):  # for tests
        self.should_stop = True


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time EMA; flags steps slower than ``threshold`` x EMA.

    On a real pod the flag triggers the controller's slice-replacement /
    re-layout path; here it feeds telemetry + the restart policy. The EMA
    warms up for ``warmup`` steps before flagging.
    """

    threshold: float = 3.0
    decay: float = 0.9
    warmup: int = 10
    ema: float = 0.0
    count: int = 0
    flagged: int = 0
    _last: Optional[float] = None

    def start(self):
        self._last = time.monotonic()

    def stop(self) -> bool:
        """Record one step; returns True if this step was a straggler."""
        assert self._last is not None, "call start() first"
        dt = time.monotonic() - self._last
        self._last = None
        self.count += 1
        if self.count <= self.warmup:
            self.ema = dt if self.ema == 0.0 else (self.decay * self.ema + (1 - self.decay) * dt)
            return False
        is_straggler = dt > self.threshold * self.ema
        if is_straggler:
            self.flagged += 1
        else:
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return is_straggler


@dataclasses.dataclass
class RestartPolicy:
    """Bounded-retry restart loop for the training CLI."""

    max_restarts: int = 3
    backoff_s: float = 1.0
    restarts: int = 0

    def run(self, fn: Callable[[], None], on_failure: Optional[Callable[[Exception], None]] = None):
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — restart loop by design
                self.restarts += 1
                if on_failure is not None:
                    on_failure(e)
                if self.restarts > self.max_restarts:
                    raise
                time.sleep(self.backoff_s * (2 ** (self.restarts - 1)))
