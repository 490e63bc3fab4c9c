"""Continuous-batching scheduler: per-step admission into freed decode lanes.

Port of the JAX package's ``serving/scheduler.py`` (pure host logic, a
copy of its own).

State machine per request:

  WAITING --admit--> PREFILL --first token--> DECODE --last token--> FINISHED
                (lane + pages assigned)                (lane + pages freed)

Admission policy is strict FIFO with head-of-line page budgeting: each step,
free lanes admit the *oldest* waiting requests whose full page need (prompt +
max_new_tokens, eager allocation) fits the pool.  If the oldest waiting
request does not fit, admission stops — younger, smaller requests do NOT skip
ahead, so no request starves behind a stream of small ones.

With a ``PrefixCache`` attached, admission first maps the request's leading
full prompt pages at cached shared pages (refcounted, read-only) and only
allocates fresh pages for the unshared tail — shared prefixes raise the
pool's effective concurrency, and the page budget accounts for that (a
request the shared pool can hold is admissible even when its full footprint
is not).  Under pressure, cache-only pages are evicted LRU to make room.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from .kv_pages import PageAllocator, PrefixCache, SCRATCH_PAGE, needed_pages

WAITING, PREFILL, DECODE, FINISHED = "waiting", "prefill", "decode", "finished"


@dataclasses.dataclass
class ServeRequest:
    """One serving request: a prompt and a generation budget."""
    request_id: str
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int
    arrival_step: int = 0
    seed: int = 0                       # per-request sampling seed (non-greedy)

    # filled in by the scheduler/engine
    state: str = WAITING
    lane: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    shared_pages: List[int] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_seq: int = -1
    admitted_step: int = -1

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.max_new_tokens

    def clone(self) -> "ServeRequest":
        """Fresh copy without scheduler/engine state, so one workload can be
        replayed through several engines."""
        return ServeRequest(self.request_id, self.prompt,
                            self.max_new_tokens, self.arrival_step,
                            seed=self.seed)


@dataclasses.dataclass
class Admission:
    request: ServeRequest
    lane: int
    pages: List[int]                    # freshly allocated (owned) pages
    shared_pages: List[int] = dataclasses.field(default_factory=list)


def max_shared_pages(prompt_len: int, page_size: int) -> int:
    """Full prompt pages a request may map shared: the page holding the last
    prompt token stays private (its hidden state seeds the first sampled
    token, and decode may keep writing into that page)."""
    return max(0, (prompt_len - 1) // page_size)


class ContinuousScheduler:
    """Maps waiting requests onto ``lanes`` decode lanes and a shared page
    pool.  Pure host-side logic — the engine owns the device compute."""

    def __init__(self, lanes: int, allocator: PageAllocator, page_size: int,
                 table_width: int, prefix_cache: Optional[PrefixCache] = None):
        self.lanes = lanes
        self.allocator = allocator
        self.page_size = page_size
        self.table_width = table_width
        self.prefix_cache = prefix_cache
        self._free_lanes: Deque[int] = deque(range(lanes))
        self._waiting: Deque[ServeRequest] = deque()
        self._active: Dict[int, ServeRequest] = {}
        self._seq = itertools.count()

    # ------------------------------------------------------------- submit
    def submit(self, req: ServeRequest) -> None:
        npages = needed_pages(req.total_tokens, self.page_size)
        if npages > self.table_width:
            raise ValueError(
                f"request {req.request_id}: {req.total_tokens} tokens need "
                f"{npages} pages > table width {self.table_width}")
        shared = 0
        if self.prefix_cache is not None:
            shared = len(self.prefix_cache.probe(
                req.prompt, max_shared_pages(req.prompt_len, self.page_size)))
        if npages - shared > self.allocator.capacity:
            raise ValueError(
                f"request {req.request_id}: needs {npages} pages "
                f"({shared} prefix-shared), pool has {self.allocator.capacity}")
        req.state = WAITING
        req.submit_seq = next(self._seq)
        self._waiting.append(req)

    # -------------------------------------------------------------- admit
    def _alloc_with_eviction(self, n: int, owner: object) -> Optional[List[int]]:
        """All-or-nothing alloc; under pressure, evict LRU prefix-cache
        entries (freeing pages no active request still refs) and retry."""
        pages = self.allocator.alloc(n, owner)
        while pages is None and self.prefix_cache is not None and len(self.prefix_cache):
            if not self.prefix_cache.evict_one():
                break
            pages = self.allocator.alloc(n, owner)
        return pages

    def admit(self, step: int, limit: Optional[int] = None) -> List[Admission]:
        """Admit the oldest waiting arrived requests into free lanes, while
        pages last.  Head-of-line blocking keeps FIFO order.  ``limit`` caps
        admissions this step (the engine's per-step prefill token budget)."""
        out: List[Admission] = []
        while self._free_lanes and self._waiting:
            if limit is not None and len(out) >= limit:
                break
            head = self._waiting[0]
            if head.arrival_step > step:
                break
            shared: List[int] = []
            if self.prefix_cache is not None:
                shared = self.prefix_cache.acquire(
                    head.prompt,
                    max_shared_pages(head.prompt_len, self.page_size), head)
            n_own = needed_pages(head.total_tokens, self.page_size) - len(shared)
            pages = self._alloc_with_eviction(n_own, head)
            if pages is None:
                if shared:
                    self.allocator.release(shared, head)
                break
            self._waiting.popleft()
            lane = self._free_lanes.popleft()
            head.state, head.lane = PREFILL, lane
            head.pages, head.shared_pages = pages, shared
            head.admitted_step = step
            self._active[lane] = head
            out.append(Admission(head, lane, pages, shared))
        return out

    # ----------------------------------------------------------- publish
    def publish_prefix(self, req: ServeRequest) -> int:
        """Register the request's full prompt pages in the prefix cache once
        their KV is committed (post-prefill).  No-op without a cache."""
        if self.prefix_cache is None:
            return 0
        n_full = req.prompt_len // self.page_size
        row = req.shared_pages + req.pages
        return self.prefix_cache.publish(req.prompt, row, n_full)

    # ------------------------------------------------------------ release
    def release(self, lane: int) -> ServeRequest:
        """Finish the request on ``lane``: drop its page refs (shared pages
        survive in other holders / the cache), return the lane to the free
        pool (it admits the oldest waiting prefill next step)."""
        req = self._active.pop(lane)
        self.allocator.release(req.pages, req)
        if req.shared_pages:
            self.allocator.release(req.shared_pages, req)
        req.state, req.lane = FINISHED, -1
        req.pages, req.shared_pages = [], []
        self._free_lanes.append(lane)
        return req

    # ------------------------------------------------------------ queries
    def active(self) -> Dict[int, ServeRequest]:
        return dict(self._active)

    def request_on(self, lane: int) -> Optional[ServeRequest]:
        return self._active.get(lane)

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def n_active(self) -> int:
        return len(self._active)

    def has_work(self) -> bool:
        return bool(self._waiting or self._active)

    def table_row(self, req: ServeRequest) -> np.ndarray:
        """The lane's page-table row: shared prefix pages first (they hold
        the leading prompt positions), then owned pages, scratch-padded to
        the fixed table width (unallocated slots are never gathered past the
        request's own positions)."""
        row = np.full((self.table_width,), SCRATCH_PAGE, np.int32)
        pages = req.shared_pages + req.pages
        row[:len(pages)] = np.asarray(pages, np.int32)
        return row
