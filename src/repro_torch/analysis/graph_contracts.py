"""The contract registry: build, run and trace every entrypoint.

Port of the JAX package's ``analysis/graph_contracts.py``. Each entrypoint
the port's perf guarantees live in gets a builder that constructs the
reference's smoke-sized instance and returns the call, which
``trace_entrypoint`` runs once under ``roofline.op_cost.OpTrace``.
``run_contract`` holds the trace to the entrypoint's ``GraphContract``.
The builders take a ``device``: ``meta`` by default (the CLI and the
tests, on the CPU) or the card. On ``meta`` the device's tensors carry
shapes only while the host's (keys, the step counter, tile seeds) stay
real CPU tensors, so the trace is the card's stream: a host read or an
upload shows as it would there, which a CPU-only run cannot show (every
tensor is on the host).

Builders accept a ``mutant`` hook used by the mutation tests (and by
``check_graphs --mutate`` to prove the gate bites):

* ``"restack"``       -- rebuilds every class stack (or page pool) of rank
  >= 4 slice by slice after the call (the reference's PR-5 data movement);
* ``"host_transfer"`` -- an ``.item()`` on the call's output (a
  device-to-host read);
* ``"f64"``           -- routes the loss (train) or the pools (serve)
  through a float64 round trip;
* ``"no_donate"``     -- clones the state before the call: the state (the
  serve pools, the train state) is then written in a copy, not in place
  (caught by the donation rule, and by the copy ceiling).

Every entrypoint writes its state in place and sets
``require_donation=True``: the train entrypoints run the donated step
(``AnalogTrainer.jit_step()``, ``begin_tiles(donate=True)``), which writes
each device state leaf into its own storage (K1's in-place mode for P and
W); the serve entrypoints write their pools with ``index_copy_``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..roofline.op_cost import OpTrace
from .contracts import ContractResult, GraphContract, check_trace

MUTANTS = ("restack", "host_transfer", "f64", "no_donate")


# --------------------------------------------------------------------------
# mutation hooks
# --------------------------------------------------------------------------

def _mutate_restack(tree):
    """Rebuild every floating leaf of rank >= 4 (a (C, n, *member) class
    stack, a page pool) slice by slice along axis 1; slices get distinct
    offsets so the rebuild is not a copy."""
    from ..core.paths import tree_map

    def r(leaf):
        if leaf.ndim >= 4 and leaf.is_floating_point():
            parts = [leaf[:, i] + i * 1e-30 for i in range(leaf.shape[1])]
            return torch.stack(parts, dim=1)
        return leaf
    return tree_map(r, tree)


def _mutate_f64(x):
    """A float64 round trip of every floating leaf."""
    from ..core.paths import tree_map

    return tree_map(lambda l: ((l.to(torch.float64) * 2.0).to(l.dtype) / 2.0
                               if l.is_floating_point() else l), x)


def _clone(tree):
    from ..core.paths import tree_map

    return tree_map(lambda l: l.clone(), tree)


def _to_device(tree, device):
    """Every leaf but the host leaves (key, step, tile seeds) on
    ``device``."""
    from ..core.paths import tree_map_with_path
    from ..core.trainer import HOST_LEAVES

    return tree_map_with_path(
        lambda p, l: l if p.split("/")[-1] in HOST_LEAVES else l.to(device),
        tree)


# --------------------------------------------------------------------------
# smoke fixtures
# --------------------------------------------------------------------------

def _quad_loss(params, batch, rng):
    return sum(torch.sum(v ** 2) for _, v in sorted(params.items())), {}


def _train_setup(backend: str, device):
    """3-block wq/wo (two spec-split groups, one 2-member class) plus an
    odd singleton: the reference's smallest instance of grouping and the
    fused flatten path."""
    from .. import prng
    from ..core.device import DeviceConfig
    from ..core.digital_opt import DigitalOptConfig, ScheduleConfig
    from ..core.plan import AnalogPlan, TilePolicy
    from ..core.tile import TileConfig
    from ..core.trainer import AnalogTrainer, TrainerConfig

    dev = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1,
                       sigma_c2c=0.05)
    extra = {"rng": "hash", "update_backend": "fused"} \
        if backend == "fused" else {}
    tile = TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                      lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.1, chopper_p=0.1,
                      **extra)
    cfg = TrainerConfig(
        tile=tile,
        digital=DigitalOptConfig(kind="sgd"),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1))
    tr = AnalogTrainer(
        _quad_loss, cfg,
        plan=AnalogPlan.of(("**", TilePolicy(tile, name="contract"))))
    params = {}
    for i in range(3):
        params[f"l{i}/attn/wq"] = torch.full((8, 8), 0.1)
        params[f"l{i}/attn/wo"] = torch.full((8, 8), 0.1)
    params["odd"] = torch.full((4, 24), 0.1)
    # drawn on the CPU (quick at this size), then moved: the state's
    # values do not change the stream the contracts read
    state = tr.init(prng.PRNGKey(0), params)
    return tr, _to_device(state, device)


def _serve_setup(device):
    from .. import prng
    from ..configs import get_config
    from ..models.lm import LM
    from ..serving import EngineConfig
    from ..serving.sampling import FeedBuilder

    cfg = get_config("qwen2-0.5b", smoke=True)
    model = LM(cfg)
    params = model.init(prng.PRNGKey(42), device)
    ecfg = EngineConfig(lanes=4, page_size=8, num_pages=33, max_len=64)
    paged = model.init_paged_cache(ecfg.lanes, ecfg.num_pages, ecfg.page_size,
                                   ecfg.max_len, device=device)
    feed = FeedBuilder(cfg, device)(torch.zeros((1, 16), dtype=torch.int32))
    return model, params, ecfg, paged, feed


# --------------------------------------------------------------------------
# entrypoint builders: name -> (call, input state); call() -> output state
# --------------------------------------------------------------------------

def _wrap_step(step, mutant: Optional[str]):
    """Apply a mutation around a train_step-shaped fn(state, batch)."""
    def run(state, batch):
        if mutant == "no_donate":
            state = _clone(state)
        new_state, metrics = step(state, batch)
        if mutant == "restack":
            from ..core.tile import TileBank

            bank = new_state["tiles"]
            new_state["tiles"] = TileBank.from_classes(
                {c: _mutate_restack(arr) for c, arr in bank.classes.items()},
                bank.index, bank.class_index, bank.policies)
        if mutant == "host_transfer":
            metrics["loss"].item()  # graphlint: allow (the planted host read)
        if mutant == "f64":
            metrics = dict(metrics, loss=_mutate_f64(metrics["loss"]))
        return new_state, metrics
    return run


def _train_step(backend: str, mutant, device):
    tr, state = _train_setup(backend, device)
    step = _wrap_step(tr.jit_step(), mutant)
    batch = torch.zeros((), device=device)
    return (lambda: step(state, batch)[0]), state


def build_train_step_scanned(mutant: Optional[str] = None, device="cpu"):
    return _train_step("vmap", mutant, device)


def build_train_step_fused(mutant: Optional[str] = None, device="cpu"):
    return _train_step("fused", mutant, device)


def build_begin_step(mutant: Optional[str] = None, device="cpu"):
    """Phase 1 alone (chopper draw / Q-tilde sync) over the bank, donated:
    written into the bank's stacks."""
    from .. import prng
    from ..core.tile import TileBank

    tr, state = _train_setup("vmap", device)
    bank = state["tiles"]
    key = prng.PRNGKey(1)

    def begin():
        b = TileBank.from_classes(_clone(bank.classes), bank.index,
                                  bank.class_index, bank.policies) \
            if mutant == "no_donate" else bank
        out = tr.begin_tiles(b, key, donate=True)
        classes = out.classes
        if mutant == "restack":
            classes = {c: _mutate_restack(a) for c, a in classes.items()}
        if mutant == "f64":
            classes = {c: _mutate_f64(a) for c, a in classes.items()}
        if mutant == "host_transfer":
            from ..core.paths import leaves

            leaves(classes)[0].sum().item()  # graphlint: allow (the planted host read)
        return TileBank.from_classes(classes, out.index, out.class_index,
                                     out.policies)

    return begin, bank


def _serve_mutate_before(paged, mutant):
    if mutant == "no_donate":
        return _clone(paged)
    if mutant == "f64":
        return _mutate_f64(paged)
    if mutant == "restack":
        return _mutate_restack(paged)
    return paged


def build_prefill_commit(mutant: Optional[str] = None, device="cpu"):
    from ..serving.sampling import sample_greedy

    model, params, ecfg, paged, feed = _serve_setup(device)
    prompt_len, page_size = 16, ecfg.page_size
    row = torch.zeros((ecfg.table_width,), dtype=torch.int32, device=device)

    def prefill_commit():
        dense = model.init_cache(1, prompt_len, device=device)
        logits, dense = model.prefill(params, feed, dense)
        tok = sample_greedy(logits)
        if mutant == "host_transfer":
            tok.sum().item()  # graphlint: allow (the planted host read)
        pools = _serve_mutate_before(paged, mutant)
        return model.commit_prefill(pools, dense, row, 0,
                                    prompt_len=prompt_len,
                                    page_size=page_size)

    return prefill_commit, paged


def _lanes_inputs(ecfg, device):
    last = torch.zeros((ecfg.lanes, 1), dtype=torch.int32, device=device)
    table = torch.zeros((ecfg.lanes, ecfg.table_width), dtype=torch.int32,
                        device=device)
    pos = torch.zeros((ecfg.lanes,), dtype=torch.int32, device=device)
    live = torch.ones((ecfg.lanes,), dtype=torch.bool, device=device)
    return last, table, pos, live


def _serve_lanes(mutant, device, gdc: bool):
    model, params, ecfg, paged, _ = _serve_setup(device)
    last, table, pos, live = _lanes_inputs(ecfg, device)
    sig0 = None
    if gdc:
        from ..core.paths import flatten_with_path

        # every matrix-shaped leaf gets calibrated (the serve path
        # calibrates exactly the analog leaves; the structure is the same)
        sig0 = {p: 1.0 for p, leaf in flatten_with_path(params)
                if leaf.ndim >= 2}

    def step_fn():
        p = params
        if gdc:
            from ..lifetime import gdc as lgdc

            p = lgdc.correct_in_graph(params, sig0)
        cache = _serve_mutate_before(paged, mutant)
        toks, cache = model.serve_step_lanes(p, last, cache, table, pos, live)
        if mutant == "host_transfer":
            toks.sum().item()  # graphlint: allow (the planted host read)
        return cache

    return step_fn, paged


def build_serve_step_lanes(mutant: Optional[str] = None, device="cpu"):
    return _serve_lanes(mutant, device, gdc=False)


def build_serve_step_lanes_gdc(mutant: Optional[str] = None, device="cpu"):
    """serve_step_lanes behind Global Drift Compensation with the alphas
    kept on the device (``lifetime.gdc.correct_in_graph``)."""
    return _serve_lanes(mutant, device, gdc=True)


def build_prefill_commit_batch(mutant: Optional[str] = None, device="cpu"):
    """The bucketed multi-lane prefill: 2 rows padded to a 16-token bucket,
    K/V scattered straight into the rows' pages."""
    from ..serving.sampling import sample_greedy

    model, params, ecfg, paged, _ = _serve_setup(device)
    B, Cb = 2, 16
    i32 = dict(dtype=torch.int32, device=device)
    tokens = torch.zeros((B, Cb), **i32)
    tables = torch.zeros((B, ecfg.table_width), **i32)
    lanes = torch.arange(B, **i32)
    starts = torch.zeros((B,), **i32)
    lengths = torch.full((B,), Cb, **i32)
    fresh = torch.ones((B,), dtype=torch.bool, device=device)

    def prefill_batch():
        pools = _serve_mutate_before(paged, mutant)
        logits, out = model.prefill_commit_batch(
            params, tokens, pools, tables, lanes, starts, lengths, fresh)
        tok = sample_greedy(logits)
        if mutant == "host_transfer":
            tok.sum().item()  # graphlint: allow (the planted host read)
        return out

    return prefill_batch, paged


ENTRYPOINTS: Dict[str, Callable] = {
    "train_step_scanned": build_train_step_scanned,
    "train_step_fused": build_train_step_fused,
    "begin_step": build_begin_step,
    "prefill_commit": build_prefill_commit,
    "serve_step_lanes": build_serve_step_lanes,
    "serve_step_lanes_gdc": build_serve_step_lanes_gdc,
    "prefill_commit_batch": build_prefill_commit_batch,
}

TRAIN_ENTRYPOINTS = ("train_step_scanned", "train_step_fused", "begin_step")


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

def _storages(tree) -> List[int]:
    from ..core.paths import leaves

    return [t.untyped_storage()._cdata for t in leaves(tree)
            if isinstance(t, torch.Tensor)]


def kept_in_place(state_in, state_out, written) -> int:
    """State leaves of ``state_out`` that are ``state_in``'s storage and
    were written in place (their storage in ``written``)."""
    before = set(_storages(state_in)) & set(written)
    return sum(1 for s in _storages(state_out) if s in before)


def trace_entrypoint(name: str, mutant: Optional[str] = None, device="meta",
                     context=None) -> Tuple[OpTrace, int]:
    """Build entrypoint ``name`` on ``device``, run it once under
    ``OpTrace`` (inside ``context()`` when given, e.g. the card's sync
    debug mode) and return (trace, state leaves kept in place)."""
    call, state_in = ENTRYPOINTS[name](mutant, torch.device(device))
    ctx = context() if context is not None else contextlib.nullcontext()
    with OpTrace() as tr:
        with ctx:
            state_out = call()
    return tr, kept_in_place(state_in, state_out, tr.written)


# --------------------------------------------------------------------------
# the contracts themselves
# --------------------------------------------------------------------------
# Memory ceilings are ~1.5x the smoke instances' bytes measured on meta
# (the fixtures are deterministic; the card's traces give the same ops
# and bytes); tightening them is free, loosening them trips the baseline
# diff. Collectives are zero in one process.

_TRAIN_DTYPES = ("bool", "float32", "int32", "int64")
_SERVE_DTYPES = ("bool", "float32", "int32", "int64")

# The train entrypoints run the donated step. min_aliased is the count
# measured: the two classes' W, P, Qd, t and prog, the c and Q~ of the
# class whose chopper flips, and the host key and step (12 device leaves
# and 2 host leaves; the begin_step fixture: both classes' prog, and c and
# Q~ of the class that flips). Their one copy of a state buffer is
# E-RIDER's Q~ <- Q on a chopper flip (Alg. 3 line 5), a real copy of one
# member tile: max_copy_bytes is the largest member's, the odd 4x24
# float32 tile (384 B). serving max_restacks=4 is the RoPE rotate-half cats
# of q and k in each of the smoke model's two layers (rank 4); a pool
# restack adds more and trips. Serve copy ceilings: the largest copy is
# the lanes' K/V read out of the pages, well under one pool.
CONTRACTS: Dict[str, GraphContract] = {
    "train_step_scanned": GraphContract(
        name="train_step_scanned",
        description="grouped engine, per-tile loop over each flattened "
                    "class: zero restacks of class stacks, no host read, "
                    "no float64",
        allowed_dtypes=_TRAIN_DTYPES,
        min_aliased=14,          # measured 14 (12 on the device)
        max_copy_bytes=384,      # measured 256: Q~ <- Q of one 8x8 member
        max_hbm_bytes=1.0e7,     # measured 6.79M
    ),
    "train_step_fused": GraphContract(
        name="train_step_fused",
        description="fused batched pulse-update backend: one K1 launch "
                    "per class array, hash RNG, the same zero-restack "
                    "guarantee",
        allowed_dtypes=_TRAIN_DTYPES,
        min_aliased=14,          # measured 14 (12 on the device)
        max_copy_bytes=384,      # measured 256: Q~ <- Q of one 8x8 member
        max_uploads=4,           # measured 4: each class array's (n, 2)
                                 # int32 seeds, one upload a K1 launch
        max_hbm_bytes=6.2e5,     # measured 410k (K1 draws its noise)
    ),
    "begin_step": GraphContract(
        name="begin_step",
        description="phase-1 chopper/Qt sync over the TileBank: the "
                    "chopper drawn on the host from host keys, no device "
                    "read",
        allowed_dtypes=_TRAIN_DTYPES,
        min_aliased=4,           # measured 4
        max_copy_bytes=384,      # measured 256: Q~ <- Q of one 8x8 member
        max_hbm_bytes=1.3e5,     # measured 57.6k
    ),
    "prefill_commit": GraphContract(
        name="prefill_commit",
        description="batch-1 dense prefill + first-token sample on the "
                    "device + paged KV commit written in place, no host "
                    "read between sample and scatter",
        allowed_dtypes=_SERVE_DTYPES,
        max_restacks=4,          # RoPE rotate-half cats
        min_aliased=2,           # measured 2 (the page pools)
        max_copy_bytes=6144,     # measured 4096
        max_hbm_bytes=2.4e6,     # measured 1.57M
    ),
    "prefill_commit_batch": GraphContract(
        name="prefill_commit_batch",
        description="bucketed multi-lane masked prefill: pools written in "
                    "place, length masking and first-token sampling on "
                    "the device, no dense-cache round trip",
        allowed_dtypes=_SERVE_DTYPES,
        max_restacks=4,          # RoPE rotate-half cats
        min_aliased=2,           # measured 2 (the page pools)
        max_copy_bytes=12288,    # measured 8192
        max_hbm_bytes=5.0e6,     # measured 3.34M
    ),
    "serve_step_lanes_gdc": GraphContract(
        name="serve_step_lanes_gdc",
        description="GDC-corrected decode step: chunked signature "
                    "reductions and the alpha correction on the device, "
                    "then the same in-place decode guarantees",
        allowed_dtypes=_SERVE_DTYPES,
        max_restacks=4,          # RoPE rotate-half cats
        min_aliased=2,           # measured 2 (the page pools)
        max_copy_bytes=49152,    # measured 32768 (the lanes' K/V read)
        max_hbm_bytes=7.9e6,     # measured 5.23M (decode + signatures)
    ),
    "serve_step_lanes": GraphContract(
        name="serve_step_lanes",
        description="one decode step across all lanes at per-lane "
                    "positions: pools written in place, zero host reads "
                    "(a read stalls every lane), no float64",
        allowed_dtypes=_SERVE_DTYPES,
        max_restacks=4,          # RoPE rotate-half cats
        min_aliased=2,           # measured 2 (the page pools)
        max_copy_bytes=49152,    # measured 32768 (the lanes' K/V read)
        max_hbm_bytes=2.5e6,     # measured 1.67M
    ),
}

assert set(CONTRACTS) == set(ENTRYPOINTS)


def run_contract(name: str, mutant: Optional[str] = None, device="meta",
                 context=None, check_hbm: bool = True) -> ContractResult:
    tr, aliased = trace_entrypoint(name, mutant, device, context)
    return check_trace(CONTRACTS[name], tr, aliased, check_hbm=check_hbm)
