"""The port's KV page accounting and scheduler against the JAX package's.

* Every case of the reference's ``tests/test_serve_scheduler.py``, the
  hypothesis properties included, replayed on ``repro_torch.serving``'s
  ``kv_pages`` and ``scheduler``: each reference test function runs with
  its module's names (``PageAllocator``, ``PrefixCache``, ``SCRATCH_PAGE``,
  ``flat_slots``, ``needed_pages``, ``ContinuousScheduler``,
  ``ServeRequest``) bound to the port's.
* One seeded random sequence of submit / admit / publish / release /
  evict, through a scheduler with a prefix cache in each package: after
  every operation the free lists, the per-page refcounts and owners, the
  prefix-cache entries, the waiting queue and every active request's lane
  and page-table row are equal.
"""
import importlib
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import kv_pages as jpages  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.serving import kv_pages, scheduler  # noqa: E402

REF = "test_serve_scheduler"
PORT_NAMES = {
    "PageAllocator": kv_pages.PageAllocator,
    "PrefixCache": kv_pages.PrefixCache,
    "SCRATCH_PAGE": kv_pages.SCRATCH_PAGE,
    "flat_slots": kv_pages.flat_slots,
    "needed_pages": kv_pages.needed_pages,
    "ContinuousScheduler": scheduler.ContinuousScheduler,
    "ServeRequest": scheduler.ServeRequest,
}


def replay(module_name: str, names: dict) -> dict:
    """The reference test module's namespace with ``names`` rebound, every
    function of the module re-created over that namespace (so its helpers
    build the port's objects too)."""
    mod = importlib.import_module(module_name)
    g = dict(vars(mod))
    g.update(names)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == mod.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    return g


def _ref_tests():
    mod = importlib.import_module(REF)
    return sorted(n for n in vars(mod) if n.startswith("test_"))


def test_replay_binds_the_port():
    g = replay(REF, PORT_NAMES)
    sched, alloc = g["_sched"]()
    assert type(sched) is scheduler.ContinuousScheduler
    assert type(alloc) is kv_pages.PageAllocator
    assert type(g["_req"](0)) is scheduler.ServeRequest
    assert len(_ref_tests()) == 15


@pytest.mark.parametrize("name", _ref_tests())
def test_reference_case_on_the_port(name):
    replay(REF, PORT_NAMES)[name]()


# ---------------------------------------------------------------------------
# one random sequence through both packages
# ---------------------------------------------------------------------------


def _snapshot(sched, alloc, cache, ids):
    """Everything the engine reads, with owners named by request id (the
    cache's own refs as "cache")."""
    def owner(o):
        return "cache" if o is cache else ids[id(o)]

    return {
        "free": list(alloc._free),
        "owners": {p: sorted(owner(o) for o in os_)
                   for p, os_ in sorted(alloc._owners.items())},
        "entries": [(k.hex(), pg, None if par is None else par.hex())
                    for k, (pg, par) in cache._entries.items()],
        "hits": (cache.hits, cache.misses),
        "waiting": [r.request_id for r in sched._waiting],
        "free_lanes": list(sched._free_lanes),
        "active": {lane: (r.request_id, r.state, list(r.pages),
                          list(r.shared_pages), sched.table_row(r).tolist())
                   for lane, r in sorted(sched._active.items())},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequence_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    ps, tw, lanes, num_pages = 4, 8, 3, 24
    prefixes = [rng.integers(0, 50, size=16).astype(np.int32) for _ in range(3)]
    sides = []
    for pk in (jpages, kv_pages):
        sk = jsched if pk is jpages else scheduler
        alloc = pk.PageAllocator(num_pages, reserved=1)
        cache = pk.PrefixCache(alloc, ps, max_entries=10)
        sides.append((sk, alloc, cache,
                      sk.ContinuousScheduler(lanes, alloc, ps, tw,
                                             prefix_cache=cache), {}))
    n_req, step, admitted, shared = 0, 0, 0, 0
    for _ in range(300):
        op = rng.choice(["submit", "submit", "admit", "release", "release",
                         "evict"])
        arg = int(rng.integers(0, 1 << 30))
        outs = []
        for sk, alloc, cache, sched, ids in sides:
            out = []
            outs.append(out)
            if op == "submit":
                plen = 5 + arg % 12
                base = prefixes[arg % 3]
                tail = np.full(max(0, plen - 16), arg % 7, np.int32)
                prompt = np.concatenate([base, tail])[:plen]
                req = sk.ServeRequest(f"r{n_req}", prompt,
                                      max_new_tokens=1 + arg % 9,
                                      arrival_step=step + arg % 2)
                ids[id(req)] = req.request_id
                try:
                    sched.submit(req)
                    out.append("ok")
                except ValueError as e:
                    out.append(str(e))
            elif op == "admit":
                adm = sched.admit(step, limit=None if arg % 3 else 1)
                for a in adm:
                    sched.publish_prefix(a.request)
                if sk is jsched:
                    admitted += len(adm)
                    shared += sum(bool(a.shared_pages) for a in adm)
                out.append([(a.request.request_id, a.lane, a.pages,
                              a.shared_pages) for a in adm])
            elif op == "release" and sched._active:
                lanes_ = sorted(sched._active)
                out.append(sched.release(lanes_[arg % len(lanes_)]).request_id)
            elif op == "evict":
                out.append(cache.evict_one())
            alloc.check_consistent()
            cache.check_consistent()
            out.append(_snapshot(sched, alloc, cache, ids))
        assert outs[0] == outs[1], (op, step)
        if op == "submit":
            n_req += 1
        step += 1
    # the sequence admits, shares prefix pages and evicts
    assert admitted >= 20 and shared >= 5, (admitted, shared)
