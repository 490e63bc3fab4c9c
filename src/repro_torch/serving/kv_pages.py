"""Fixed-size KV page accounting for the continuous-batching engine.

Port of the JAX package's ``serving/kv_pages.py``: pure Python, a copy
of its own (the port imports nothing of the reference).

The physical pools live in the model's paged decode cache
(``models/lm.py:init_paged_cache``): per attention layer, ``num_pages`` pages
of ``page_size`` token slots, shared by all lanes.  This module owns the
host-side bookkeeping: which pages belong to which request, and the index
math that turns a page-table row into flat pool slots (the same formula the
paged gather/scatter in ``models/attention.py`` uses).

Page 0 is reserved as a scratch page: free decode lanes point their whole
table row at it so their (masked-out) writes never touch live pages.

Copy-on-write prefix sharing: pages are *refcounted* (one owner entry per
holder).  A request whose leading full prompt pages hash-hit the
``PrefixCache`` maps those table-row entries at the shared physical pages
read-only (``share`` adds a ref) and only prefills the unshared tail;
``release`` drops one ref and returns the page to the free list at zero.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

SCRATCH_PAGE = 0


def needed_pages(total_tokens: int, page_size: int) -> int:
    """Pages a request occupying ``total_tokens`` slots (prompt + generated)
    needs; the engine allocates them all at admission (eager allocation)."""
    return -(-total_tokens // page_size)


def flat_slots(table_row: List[int], page_size: int, length: int) -> List[int]:
    """Flat physical pool slot of logical positions 0..length-1 — the pure
    reference for the on-device index math (used by tests)."""
    return [table_row[j // page_size] * page_size + j % page_size
            for j in range(length)]


class PageAllocator:
    """Refcounted free-list page allocator with leak / double-free checking.

    ``alloc`` is all-or-nothing: a request that does not fit leaves the free
    list untouched (the scheduler then blocks admission rather than holding
    a partial allocation).  Every page carries a list of owner refs:
    ``alloc`` creates the first ref, ``share`` adds one (copy-on-write
    prefix sharing), and ``release``/``free`` drops one — the page returns
    to the free list only when the last ref goes.  Releasing a page the
    given owner does not hold fails loudly (double free / cross-request
    free) instead of corrupting the pool.
    """

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(f"num_pages={num_pages} must exceed reserved={reserved}")
        self.num_pages = num_pages
        self.reserved = reserved
        self._free: Deque[int] = deque(range(reserved, num_pages))
        self._owners: Dict[int, List[object]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.num_pages - self.reserved

    def refcount(self, page: int) -> int:
        return len(self._owners.get(page, ()))

    def alloc(self, n: int, owner: object) -> Optional[List[int]]:
        """Allocate ``n`` pages for ``owner``; None (and no change) if the
        pool cannot satisfy the request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._owners[p] = [owner]
        return pages

    def share(self, pages: List[int], owner: object) -> None:
        """Add a ref to already-allocated pages (prefix sharing): ``owner``
        maps them read-only; the pages outlive every individual holder."""
        for p in pages:
            if p not in self._owners:
                raise ValueError(f"page {p} is free; cannot share")
        for p in pages:
            self._owners[p].append(owner)

    def release(self, pages: List[int], owner: object) -> None:
        """Drop one of ``owner``'s refs per page; free pages at refcount 0.
        Checks *all* pages before mutating so a bad batch changes nothing."""
        for p in pages:
            owners = self._owners.get(p)
            if owners is None or owner not in owners:
                raise ValueError(
                    f"page {p} not allocated to {owner!r} (double free or "
                    f"cross-request free)")
        for p in pages:
            owners = self._owners[p]
            owners.remove(owner)
            if not owners:
                del self._owners[p]
                self._free.append(p)

    # historical name — single-ref release (kept for callers/tests predating
    # refcounts; identical semantics now that a ref is one owner entry)
    free = release

    def check_consistent(self) -> None:
        """Invariant: every page is exactly free or allocated (refcount >= 1),
        never both."""
        free = set(self._free)
        allocated = set(self._owners)
        assert len(free) == len(self._free), "duplicate pages on the free list"
        assert not (free & allocated), f"pages both free and allocated: {free & allocated}"
        universe = set(range(self.reserved, self.num_pages))
        assert free | allocated == universe, "leaked pages"
        for p, owners in self._owners.items():
            assert len(owners) >= 1, f"page {p} allocated with zero refs"


# ---------------------------------------------------------------------------
# prefix cache (copy-on-write prompt-prefix sharing)
# ---------------------------------------------------------------------------


def _page_keys(prompt, page_size: int, n_pages: int) -> List[bytes]:
    """Chained digest per full prompt page: key_i commits to tokens
    [0, (i+1)*page_size), so equal keys mean equal *prefixes*, not just
    equal pages."""
    import numpy as np

    keys = []
    h = b""
    for i in range(n_pages):
        chunk = np.ascontiguousarray(
            np.asarray(prompt[i * page_size:(i + 1) * page_size], np.int32))
        h = hashlib.sha1(h + chunk.tobytes()).digest()
        keys.append(h)
    return keys


class PrefixCache:
    """Maps chained page-content digests to physical pages so admissions with
    a common prompt prefix reuse (refcounted, read-only) committed KV pages.

    The cache holds its own ref on every entry's page, so cached pages
    survive their publisher finishing.  Eviction is LRU over chain *roots*:
    an entry never outlives its parent (a child's key chains through the
    parent's, so a child without its parent could never be probed again) —
    evicting an entry cascades to its descendants.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_entries: int = 0):
        self.allocator = allocator
        self.page_size = page_size
        self.max_entries = max_entries          # 0 = unbounded (evict on demand)
        # key -> (page, parent_key | None); OrderedDict keeps LRU order
        self._entries: "OrderedDict[bytes, Tuple[int, Optional[bytes]]]" = OrderedDict()
        self._children: Dict[bytes, set] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -------------------------------------------------------------- probe
    def probe(self, prompt, max_pages: int) -> List[int]:
        """Longest run of leading full prompt pages present in the cache
        (up to ``max_pages``).  Touches hit entries for LRU."""
        pages: List[int] = []
        for key in _page_keys(prompt, self.page_size, max_pages):
            entry = self._entries.get(key)
            if entry is None:
                break
            self._entries.move_to_end(key)
            pages.append(entry[0])
        self.hits += len(pages)
        self.misses += max_pages - len(pages)
        return pages

    def acquire(self, prompt, max_pages: int, owner: object) -> List[int]:
        """Probe + take a ref per hit page for ``owner``."""
        pages = self.probe(prompt, max_pages)
        if pages:
            self.allocator.share(pages, owner)
        return pages

    # ------------------------------------------------------------ publish
    def publish(self, prompt, pages: List[int], n_pages: int) -> int:
        """Register ``prompt``'s first ``n_pages`` full pages (physical ids
        ``pages[:n_pages]``).  The cache refs every newly-registered page.
        Returns how many entries were added."""
        added = 0
        parent: Optional[bytes] = None
        for i, key in enumerate(_page_keys(prompt, self.page_size, n_pages)):
            if key in self._entries:
                self._entries.move_to_end(key)
            else:
                self.allocator.share([pages[i]], self)
                self._entries[key] = (pages[i], parent)
                if parent is not None:
                    self._children.setdefault(parent, set()).add(key)
                added += 1
            parent = key
        while self.max_entries and len(self._entries) > self.max_entries:
            if not self.evict_one():
                break
        return added

    # ------------------------------------------------------------- evict
    def _remove(self, key: bytes) -> None:
        page, parent = self._entries.pop(key)
        if parent is not None and parent in self._children:
            self._children[parent].discard(key)
            if not self._children[parent]:
                del self._children[parent]
        for child in sorted(self._children.pop(key, ())):
            if child in self._entries:
                self._remove(child)
        self.allocator.release([page], self)

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry (and its descendants),
        releasing the cache's refs.  Returns False when empty."""
        if not self._entries:
            return False
        key = next(iter(self._entries))
        self._remove(key)
        return True

    def clear(self) -> None:
        while self.evict_one():
            pass

    def check_consistent(self) -> None:
        """Every cached page is allocated with the cache among its owners;
        every child's parent is present."""
        for key, (page, parent) in self._entries.items():
            assert self.allocator.refcount(page) >= 1, f"cached page {page} is free"
            assert parent is None or parent in self._entries, \
                "cache entry outlived its parent"
