"""Layer blocks and the period stack: training and the serve modes.

Port of the JAX package's ``models/blocks.py``. A model stack = ``prefix``
layers (unrolled; e.g. DeepSeek's leading dense-FFN layer) + ``body`` =
cfg.pattern repeated cfg.n_periods times, its parameters stacked along a
leading ``n_periods`` axis per position in the period + ``tail`` layers
(unrolled; e.g. RecurrentGemma's trailing [rec, rec]). Every layer kind is
pre-norm -> sequence mixer (attention, MLA, RG-LRU or SSD) -> residual ->
pre-norm -> MLP or MoE -> residual; SSD blocks have no separate MLP.
Decoder stacks of enc-dec models carry a cross-attention sub-block.

Where the reference scans the periods (``lax.scan``), the port loops over
``leaf[i]`` of the stacked leaves, so a gradient reaches the stacked leaf
and the analog tiles hold the stacked arrays. ``cfg.remat`` wraps one
period in ``torch.utils.checkpoint`` as ``jax.checkpoint`` wraps
``period_fn``; its recompute re-enters the forward's data and model axes
(``common.parallel_context``) and, under a model axis, runs the whole
period, so the collectives it issues are the forward's on every rank
(every mixer's, the cross sub-block's and SSD's norm sums included).

The serve modes (``prefill``: the fixed-batch driver's dense cache;
``chunk``: the engine's bucketed/chunked prefill into the paged cache;
``decode``: dense, or per lane against the paged cache when a page table
is passed) run for every layer kind: shared K/V page pools for
``attn`` / ``attn_local``, per-lane latent rows for ``mla``, per-lane
recurrent state for ``rec`` / ``ssm``, and the cross-attention K/V of an
encoder-decoder's decoder (fixed driver only). Caches are written in
place: a period's cache is the ``leaf[i]`` view of the stacked cache
leaves, as its parameters are. As a rank of a mesh (``prefill`` and dense
``decode`` with ``shards``, a ``distributed.sharding.CacheShards``) the
caches are the rank's blocks, each layer's met as the rows the rank
computes and put back after the layer wrote it; a state is written in its
block's cut over the model axis (``common.to_model_block``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec, tree_map
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec_mod
from .common import (model_size, parallel_context, rms_norm, to_model_block,
                     zeros)

SERVING_MODES = ("prefill", "chunk", "decode")


def check_ported(mode: str) -> None:
    """Raise ``ValueError`` for an unknown mode."""
    if mode != "fwd" and mode not in SERVING_MODES:
        raise ValueError(mode)


# ---------------------------------------------------------------------------
# single-layer init/apply
# ---------------------------------------------------------------------------


def _layer_is_moe(cfg: ModelConfig, global_idx: int) -> bool:
    return bool(cfg.n_experts) and global_idx >= cfg.first_dense_layers


def init_layer(key, cfg: ModelConfig, kind: str, global_idx: int,
               cross: bool = False, device="cuda") -> Dict:
    ks = prng.split(key, 4)
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": zeros((d,), cfg.dtype, device)}
    if kind in ("attn", "attn_local"):
        p["attn"] = attn.init_attn(ks[0], cfg, device=device)
    elif kind == "mla":
        p["attn"] = attn.init_mla(ks[0], cfg, device=device)
    elif kind == "rec":
        p["mix"] = rec_mod.init_rglru(ks[0], cfg, device=device)
    elif kind == "ssm":
        p["mix"] = rec_mod.init_ssm(ks[0], cfg, device=device)
    else:
        raise ValueError(kind)
    if kind != "ssm":
        p["ln2"] = zeros((d,), cfg.dtype, device)
        if _layer_is_moe(cfg, global_idx):
            p["moe"] = moe_mod.init_moe(ks[1], cfg, device=device)
        else:
            p["mlp"] = moe_mod.init_mlp(ks[1], cfg, device=device)
    if cross:
        p["lnx"] = zeros((d,), cfg.dtype, device)
        p["cross"] = attn.init_attn(ks[2], cfg, cross=True, device=device)
    return p


def make_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     enc_len: int = 0, cross: bool = False, abstract=False,
                     device="cuda") -> Dict:
    """The fixed-batch driver's dense decode cache of one layer."""
    c: Dict[str, Any] = {}
    if kind in ("attn", "attn_local"):
        c["kv"] = attn.make_attn_cache(cfg, kind, batch, seq_len, abstract,
                                       device)
    elif kind == "mla":
        c["kv"] = attn.make_mla_cache(cfg, batch, seq_len, abstract, device)
    elif kind == "rec":
        c["state"] = rec_mod.make_rglru_state(cfg, batch, abstract, device)
    elif kind == "ssm":
        c["state"] = rec_mod.make_ssm_state(cfg, batch, abstract, device)
    if cross:
        KV, D = cfg.n_kv, cfg.head_dim
        c.update(attn._cache_leaves(
            {"ck": ((batch, enc_len, KV, D), cfg.dtype),
             "cv": ((batch, enc_len, KV, D), cfg.dtype)}, abstract, device))
    return c


def _write(old, new):
    """Write a new state tree into the cache's leaves, in place (under
    ``common.model_parallel`` the compute's cut of each state put in its
    block's, ``common.to_model_block``)."""
    tree_map(lambda o, n: o.copy_(to_model_block(n, o.shape)), old, new)


def _write_rows(old, new, rows):
    """Write a new state tree's rows into the cache's rows ``rows``."""
    tree_map(lambda o, n: o.index_copy_(0, rows, n.to(o.dtype)), old, new)


def apply_layer(p: Dict, x, cfg: ModelConfig, kind: str, mode: str, *,
                positions=None, cache: Optional[Dict] = None, pos=None,
                enc_out=None, causal: bool = True, table=None, lengths=None,
                lane_idx=None, fresh=None, live=None):
    """Returns (x_out, aux_loss, new_cache). ``table`` (B,T) page table
    selects the paged per-lane decode; ``lengths`` (B,) is the valid run
    per row of mode ``chunk``, ``lane_idx`` (B,) its decode lane and
    ``fresh`` (B,) its first-chunk flag (zero prior state). ``live`` (B,)
    masks the per-lane writes of the paged decode: page-pool layers park
    idle lanes on the scratch page, but MLA latent rows and rec/ssm state
    have no scratch row, and without the mask the decode step that runs
    between prefill chunks would overwrite a mid-chunk lane's carried
    state. The cache is written in place and returned."""
    check_ported(mode)
    rs = cfg.residual_scale
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    lanes = table is not None

    def hold_idle(new, old):
        """The reference's ``where(live, new, old)``, written into ``old``."""
        if live is None:
            _write(old, new)
            return
        m = live.to(torch.bool)
        tree_map(lambda o, n: o.copy_(torch.where(
            m.view(-1, *([1] * (n.dim() - 1))), n.to(o.dtype), o)), old, new)

    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        if mode == "fwd":
            mix = attn.attn_forward(p["attn"], h, cfg, kind=kind,
                                    positions=positions, causal=causal)
        elif mode == "prefill":
            mix, _ = attn.attn_prefill(p["attn"], h, cfg, kind=kind,
                                       positions=positions, cache=cache["kv"])
        elif mode == "chunk":
            mix, _ = attn.attn_chunk_paged(p["attn"], h, cfg, kind=kind,
                                           positions=positions, lengths=lengths,
                                           table=table, cache=cache["kv"])
        elif lanes:
            mix, _ = attn.attn_decode_paged(p["attn"], h, cfg, kind=kind,
                                            pos=pos, table=table,
                                            cache=cache["kv"])
        else:
            mix, _ = attn.attn_decode(p["attn"], h, cfg, kind=kind, pos=pos,
                                      cache=cache["kv"])
    elif kind == "mla":
        if mode == "fwd":
            mix = attn.mla_forward(p["attn"], h, cfg, positions=positions,
                                   causal=causal)
        elif mode == "prefill":
            mix, _ = attn.mla_prefill(p["attn"], h, cfg, positions=positions,
                                      cache=cache["kv"])
        elif mode == "chunk":
            mix, _ = attn.mla_chunk_lanes(p["attn"], h, cfg,
                                          positions=positions, lengths=lengths,
                                          lanes=lane_idx, cache=cache["kv"])
        elif lanes:
            mix, _ = attn.mla_decode_lanes(p["attn"], h, cfg, pos=pos,
                                           cache=cache["kv"], live=live)
        else:
            mix, _ = attn.mla_decode(p["attn"], h, cfg, pos=pos,
                                     cache=cache["kv"])
    elif kind == "rec":
        if mode == "fwd":
            mix = rec_mod.rglru_forward(p["mix"], h, cfg)
        elif mode == "prefill":
            mix, st = rec_mod.rglru_forward_with_state(p["mix"], h, cfg)
            _write(cache["state"], st)
        elif mode == "chunk":
            # exact-length, fresh-only batched prefill: the engine never
            # pads or chunks rec rows (the associative scan's tree is not
            # stable under a padded tail)
            mix, st = rec_mod.rglru_forward_with_state(p["mix"], h, cfg)
            _write_rows(cache["state"], st, lane_idx.long())
        else:
            mix, st = rec_mod.rglru_decode(p["mix"], h, cache["state"], cfg)
            hold_idle(st, cache["state"])
    elif kind == "ssm":
        if mode == "fwd":
            mix = rec_mod.ssm_forward(p["mix"], h, cfg)
        elif mode == "prefill":
            mix, st = rec_mod.ssm_forward_with_state(p["mix"], h, cfg)
            _write(cache["state"], st)
        elif mode == "chunk":
            rows = lane_idx.long()
            mask = fresh.to(torch.bool)

            def gather_row(lc):
                g = lc[rows]      # a copy, read before the rows are written
                return torch.where(mask.view(-1, *([1] * (g.dim() - 1))),
                                   torch.zeros((), dtype=g.dtype,
                                               device=g.device), g)

            prev = tree_map(gather_row, cache["state"])
            mix, st = rec_mod.ssm_forward_with_state(p["mix"], h, cfg,
                                                     state=prev,
                                                     lengths=lengths)
            _write_rows(cache["state"], st, rows)
        else:
            mix, st = rec_mod.ssm_decode(p["mix"], h, cache["state"], cfg)
            hold_idle(st, cache["state"])
    else:
        raise ValueError(kind)
    x = x + rs * mix

    if "cross" in p:
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        if mode == "fwd":
            cx = attn.cross_forward(p["cross"], hx, enc_out, cfg)
        elif mode == "prefill":
            # the cross K/V are cached at prefill; decode reuses them
            cx = attn.cross_prefill(p["cross"], hx, enc_out, cfg, cache)
        else:
            cx = attn.cross_decode(p["cross"], hx, cfg, cache)
        x = x + rs * cx

    if kind != "ssm":
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            ff, aux = moe_mod.moe_forward(p["moe"], h2, cfg)
        else:
            ff = moe_mod.mlp_forward(p["mlp"], h2, cfg)
        x = x + rs * ff
    return x, aux, (cache if (cache is not None or mode != "fwd") else None)


# ---------------------------------------------------------------------------
# stack machinery: prefix (unrolled) + body (periods) + tail
# ---------------------------------------------------------------------------


def stack_structure(cfg: ModelConfig) -> Tuple[List[str], List[str], List[str], int]:
    kinds = list(cfg.layer_kinds)
    nprefix = cfg.first_dense_layers
    prefix = kinds[:nprefix]
    rest = kinds[nprefix:]
    period = list(cfg.pattern)
    tail = list(cfg.tail)
    # how many full periods fit in `rest` before the tail
    body_len = len(rest) - len(tail)
    assert body_len % len(period) == 0, (cfg.name, body_len, period)
    n_periods = body_len // len(period)
    return prefix, period, tail, n_periods


def _stack(layers):
    return tree_map(lambda *ls: torch.stack(ls), *layers)


def init_stack(key, cfg: ModelConfig, cross: bool = False, device="cuda") -> Dict:
    """Parameters of the stack. The body's leaves of position j in the
    period stack the ``n_periods`` layers drawn from ``split(fold_in(key,
    kidx), n_periods)``, as the reference's vmapped init draws them."""
    prefix, period, tail, n_periods = stack_structure(cfg)
    params: Dict[str, Any] = {"prefix": {}, "body": {}, "tail": {}}
    kidx = 0

    def nk():
        nonlocal kidx
        kidx += 1
        return prng.fold_in(key, kidx)

    for i, kind in enumerate(prefix):
        params["prefix"][f"l{i}"] = init_layer(nk(), cfg, kind, i, cross, device)
    for j, kind in enumerate(period):
        if n_periods == 0:
            continue
        keys = prng.split(nk(), n_periods)
        gidx = len(prefix) + j
        params["body"][f"p{j}"] = _stack(
            [init_layer(keys[i], cfg, kind, gidx, cross, device)
             for i in range(n_periods)])
    for i, kind in enumerate(tail):
        gidx = len(prefix) + n_periods * len(period) + i
        params["tail"][f"l{i}"] = init_layer(nk(), cfg, kind, gidx, cross, device)
    return params


def _stack_leaf(leaf, n: int, abstract: bool):
    if abstract:
        return TensorSpec((n,) + tuple(leaf.shape), leaf.dtype, leaf.device)
    return leaf[None].expand((n,) + tuple(leaf.shape)).clone()


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                     enc_len=0, cross=False, abstract=False,
                     device="cuda") -> Dict:
    prefix, period, tail, n_periods = stack_structure(cfg)
    cache: Dict[str, Any] = {"prefix": {}, "body": {}, "tail": {}}

    def one(kind):
        return make_layer_cache(cfg, kind, batch, seq_len, enc_len, cross,
                                abstract, device)

    for i, kind in enumerate(prefix):
        cache["prefix"][f"l{i}"] = one(kind)
    for j, kind in enumerate(period):
        if n_periods == 0:
            continue
        cache["body"][f"p{j}"] = tree_map(
            lambda leaf: _stack_leaf(leaf, n_periods, abstract), one(kind))
    for i, kind in enumerate(tail):
        cache["tail"][f"l{i}"] = one(kind)
    return cache


# ---------------------------------------------------------------------------
# paged decode caches (continuous-batching serve engine)
# ---------------------------------------------------------------------------
#
# attn/attn_local — shared page pools (num_pages, page_size, KV, D); all
#                   layers index the same per-lane page-table row.
# mla             — per-lane dense latent rows (lanes, max_len, ...) with a
#                   per-lane position row for stale-slot invalidation.
# rec/ssm         — per-lane recurrent state, the dense cache's layout.


def make_paged_layer_cache(cfg: ModelConfig, kind: str, lanes: int,
                           num_pages: int, page_size: int, max_len: int,
                           abstract=False, device="cuda") -> Dict:
    c: Dict[str, Any] = {}
    if kind in ("attn", "attn_local"):
        c["kv"] = attn.make_paged_attn_cache(cfg, num_pages, page_size,
                                             abstract, device)
    elif kind == "mla":
        c["kv"] = attn.make_mla_lane_cache(cfg, lanes, max_len, abstract,
                                           device)
    elif kind == "rec":
        c["state"] = rec_mod.make_rglru_state(cfg, lanes, abstract, device)
    elif kind == "ssm":
        c["state"] = rec_mod.make_ssm_state(cfg, lanes, abstract, device)
    return c


def init_paged_stack_cache(cfg: ModelConfig, lanes: int, num_pages: int,
                           page_size: int, max_len: int, abstract=False,
                           device="cuda") -> Dict:
    prefix, period, tail, n_periods = stack_structure(cfg)
    cache: Dict[str, Any] = {"prefix": {}, "body": {}, "tail": {}}

    def one(kind):
        return make_paged_layer_cache(cfg, kind, lanes, num_pages, page_size,
                                      max_len, abstract, device)

    for i, kind in enumerate(prefix):
        cache["prefix"][f"l{i}"] = one(kind)
    for j, kind in enumerate(period):
        if n_periods == 0:
            continue
        cache["body"][f"p{j}"] = tree_map(
            lambda leaf: _stack_leaf(leaf, n_periods, abstract), one(kind))
    for i, kind in enumerate(tail):
        cache["tail"][f"l{i}"] = one(kind)
    return cache


def commit_layer_prefill(cfg: ModelConfig, kind: str, paged: Dict,
                         dense: Dict, idx, lane, *, stacked: bool) -> Dict:
    """Write one layer's batch-1 dense prefill cache into the paged cache
    (in place): K/V pages at flat slots ``idx`` (S,), lane-dense latent
    rows and recurrent state at row ``lane``."""
    if kind in ("attn", "attn_local"):
        attn.commit_prefill_pages(paged["kv"], dense["kv"], idx, stacked=stacked)
    elif kind == "mla":
        attn.commit_prefill_mla(paged["kv"], dense["kv"], lane, stacked=stacked)
    else:             # rec / ssm: overwrite the lane's recurrent state
        def put(lc, dc):
            if stacked:
                lc[:, lane] = dc[:, 0].to(lc.dtype)
            else:
                lc[lane] = dc[0].to(lc.dtype)

        tree_map(put, paged["state"], dense["state"])
    return paged


def commit_stack_prefill(cfg: ModelConfig, paged: Dict, dense: Dict, idx,
                         lane) -> Dict:
    """Walk the stack structure and commit every layer's prefill cache."""
    prefix, period, tail, n_periods = stack_structure(cfg)
    for i, kind in enumerate(prefix):
        commit_layer_prefill(cfg, kind, paged["prefix"][f"l{i}"],
                             dense["prefix"][f"l{i}"], idx, lane, stacked=False)
    for j, kind in enumerate(period):
        if n_periods == 0:
            continue
        commit_layer_prefill(cfg, kind, paged["body"][f"p{j}"],
                             dense["body"][f"p{j}"], idx, lane, stacked=True)
    for i, kind in enumerate(tail):
        commit_layer_prefill(cfg, kind, paged["tail"][f"l{i}"],
                             dense["tail"][f"l{i}"], idx, lane, stacked=False)
    return paged


def apply_stack(params: Dict, x, cfg: ModelConfig, mode: str, *,
                positions=None, caches: Optional[Dict] = None, pos=None,
                enc_out=None, causal: bool = True, table=None, lengths=None,
                lane_idx=None, fresh=None, live=None, shards=None):
    """Returns (x, aux_total, caches): ``caches`` (written in place, the
    same dict) when given, else None. ``shards`` (a
    ``distributed.sharding.CacheShards``; modes ``prefill`` and dense
    ``decode``): ``caches`` are a rank's blocks, each layer's met as the
    rows the rank computes and put back after the layer wrote it."""
    check_ported(mode)
    if shards is not None and (mode not in ("prefill", "decode")
                               or table is not None):
        raise ValueError("cache blocks serve the fixed driver's prefill and "
                         "decode only")
    prefix, period, tail, n_periods = stack_structure(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    decode = mode == "decode"
    length = x.shape[1]

    def run_layer(p, x, kind, cache):
        return apply_layer(p, x, cfg, kind, mode, positions=positions,
                           cache=cache, pos=pos, enc_out=enc_out,
                           causal=causal, table=table, lengths=lengths,
                           lane_idx=lane_idx, fresh=fresh, live=live)

    def layer(name, p, x, kind, tree, i=None):
        """Layer ``i`` (None: unstacked) of the cache part ``name``."""
        if tree is None or shards is None:
            c = tree if (tree is None or i is None) else tree_map(
                lambda leaf: leaf[i], tree)
            return run_layer(p, x, kind, c)
        c = shards.view(name, i, tree, read=decode)
        out = run_layer(p, x, kind, c)
        shards.commit(name, i, tree, c, decode, pos=pos, length=length)
        return out

    def part(name, key):
        return caches[name][key] if caches is not None else None

    for i, kind in enumerate(prefix):
        x, aux, _ = layer(f"prefix/l{i}", params["prefix"][f"l{i}"], x, kind,
                          part("prefix", f"l{i}"))
        aux_total = aux_total + aux

    if n_periods > 0:
        body = [params["body"][f"p{j}"] for j in range(len(period))]
        body_c = [part("body", f"p{j}") for j in range(len(period))]

        def period_fn(h, aux_acc, i):
            for j, kind in enumerate(period):
                h, aux, _ = layer(f"body/p{j}",
                                  tree_map(lambda l: l[i], body[j]), h, kind,
                                  body_c[j], i)
                aux_acc = aux_acc + aux
            return h, aux_acc

        remat = cfg.remat and mode == "fwd" and torch.is_grad_enabled()
        # the recompute runs where backward runs (autograd's device
        # threads): under the forward's data and model axes, and to the
        # period's end, so every rank issues the same collectives in the
        # same order whatever saved tensors it needs first
        enter = parallel_context()
        with (set_checkpoint_early_stop(False) if model_size() > 1
              else contextlib.nullcontext()):
            for i in range(n_periods):
                if remat:
                    x, aux_total = checkpoint(
                        period_fn, x, aux_total, i, use_reentrant=False,
                        context_fn=lambda: (contextlib.nullcontext(),
                                            enter()))
                else:
                    x, aux_total = period_fn(x, aux_total, i)

    for i, kind in enumerate(tail):
        x, aux, _ = layer(f"tail/l{i}", params["tail"][f"l{i}"], x, kind,
                          part("tail", f"l{i}"))
        aux_total = aux_total + aux
    return x, aux_total, caches
