"""Host data pipeline: background prefetch, then placement on the device.

Port of the JAX package's ``data/pipeline.py``. A daemon thread calls
``producer(step)`` for steps ``start_step, start_step + 1, ...`` into a
queue of ``depth`` batches. ``__next__`` places the next batch on the
consumer's thread, as the reference's ``_place`` does: with ``device`` set,
every numpy array becomes a tensor there. For a CUDA device the thread
copies each batch into pinned host memory first, so the copy to the card is
``non_blocking`` and overlaps the consumer's work.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.paths import tree_map


class Prefetcher:
    """Wraps a batch-producing callable with a depth-N background queue."""

    def __init__(self, producer: Callable[[int], Dict[str, np.ndarray]],
                 start_step: int = 0, depth: int = 2, device=None):
        self.producer = producer
        self.device = None if device is None else torch.device(device)
        self._pin = self.device is not None and self.device.type == "cuda"
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _host(self, batch):
        """Tensors in (pinned, for a CUDA device) host memory."""
        if self.device is None:
            return batch
        return tree_map(
            lambda x: (torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                       if self._pin else torch.from_numpy(np.array(x))), batch)

    def _place(self, batch):
        if self.device is None:
            return batch
        return tree_map(lambda t: t.to(self.device, non_blocking=self._pin),
                        batch)

    def _run(self):
        while not self._stop.is_set():
            try:
                batch = self._host(self.producer(self._step))
            except Exception as e:  # raised again by the consumer's next()
                batch = e
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return self._place(batch)

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop the producer thread and wait up to ``timeout`` s for it."""
        self._stop.set()
        self._thread.join(timeout)
