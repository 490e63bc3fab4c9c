"""Layer blocks and the period stack (the full-sequence ``fwd`` mode).

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
``period_fn``.

The serve modes (``prefill``: the fixed-batch driver's dense cache;
``chunk``: the engine's bucketed/chunked prefill into the paged pools;
``decode``: dense, or per lane against the paged pools when a page table
is passed) and their cache makers are ported for the page-pool attention
kinds ``attn`` / ``attn_local``, with any FFN (dense or MoE). Caches are
written in place: a period's cache is the ``leaf[i]`` view of the stacked
cache leaves, as its parameters are. The serve modes of ``mla``, ``rec``,
``ssm`` and of the cross-attention sub-block raise
``NotImplementedError`` naming ROADMAP item 14b, before any layer runs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec, tree_map
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec_mod
from .common import rms_norm, zeros

SERVING_MODES = ("prefill", "chunk", "decode")
PAGE_POOL_KINDS = ("attn", "attn_local")


def check_ported(mode: str, cfg: Optional[ModelConfig] = None) -> None:
    """Raise ``ValueError`` for an unknown mode, and
    ``NotImplementedError`` for a serve mode of a layer kind whose cache is
    not ported yet (MLA's latent rows, RG-LRU and SSD state, the
    encoder-decoder's cross-attention cache; ROADMAP item 14b)."""
    if mode == "fwd":
        return
    if mode not in SERVING_MODES:
        raise ValueError(mode)
    if cfg is None:
        return
    kinds = sorted(set(cfg.layer_kinds) - set(PAGE_POOL_KINDS))
    if kinds or cfg.is_encdec:
        what = ", ".join(kinds + (["cross-attention"] if cfg.is_encdec else []))
        raise NotImplementedError(
            f"mode {mode!r} of {cfg.name}: the serve caches of {what} come "
            f"with ROADMAP.md queue 1 item 14b (MLA latent rows, RG-LRU and "
            f"SSD state, the cross-attention cache); the port serves the "
            f"page-pool attention kinds {', '.join(PAGE_POOL_KINDS)}")


def _check_kind(kind: str, cross: bool = False) -> None:
    if kind not in PAGE_POOL_KINDS or cross:
        raise NotImplementedError(
            f"the serve cache of {'cross-attention' if cross else kind} "
            f"comes with ROADMAP.md queue 1 item 14b")


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
    _check_kind(kind, cross)
    return {"kv": attn.make_attn_cache(cfg, kind, batch, seq_len, abstract,
                                       device)}


def apply_layer(p: Dict, x, cfg: ModelConfig, kind: str, mode: str, *,
                positions=None, cache: Optional[Dict] = None, pos=None,
                enc_out=None, causal: bool = True, table=None, lengths=None):
    """Returns (x_out, aux_loss, new_cache). ``table`` (B,T) page table
    selects the paged per-lane decode; ``lengths`` (B,) is the valid run
    per row of mode ``chunk``. The cache is written in place and
    returned."""
    check_ported(mode)
    rs = cfg.residual_scale
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode != "fwd":
        _check_kind(kind, "cross" in p)
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
        elif table is not None:
            mix, _ = attn.attn_decode_paged(p["attn"], h, cfg, kind=kind,
                                            pos=pos, table=table,
                                            cache=cache["kv"])
        else:
            mix, _ = attn.attn_decode(p["attn"], h, cfg, kind=kind, pos=pos,
                                      cache=cache["kv"])
    elif kind == "mla":
        mix = attn.mla_forward(p["attn"], h, cfg, positions=positions,
                               causal=causal)
    elif kind == "rec":
        mix = rec_mod.rglru_forward(p["mix"], h, cfg)
    elif kind == "ssm":
        mix = rec_mod.ssm_forward(p["mix"], h, cfg)
    else:
        raise ValueError(kind)
    x = x + rs * mix

    if "cross" in p:
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + rs * attn.cross_forward(p["cross"], hx, enc_out, cfg)

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
    check_ported("prefill", cfg)
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
#                   layers index the same per-lane page-table row. (MLA's
#                   per-lane latent rows and rec/ssm per-lane state: item 14b.)


def make_paged_layer_cache(cfg: ModelConfig, kind: str, lanes: int,
                           num_pages: int, page_size: int, max_len: int,
                           abstract=False, device="cuda") -> Dict:
    _check_kind(kind)
    return {"kv": attn.make_paged_attn_cache(cfg, num_pages, page_size,
                                             abstract, device)}


def init_paged_stack_cache(cfg: ModelConfig, lanes: int, num_pages: int,
                           page_size: int, max_len: int, abstract=False,
                           device="cuda") -> Dict:
    check_ported("decode", cfg)
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
    (in place): K/V pages at flat slots ``idx`` (S,)."""
    _check_kind(kind)
    attn.commit_prefill_pages(paged["kv"], dense["kv"], idx, stacked=stacked)
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
                enc_out=None, causal: bool = True, table=None, lengths=None):
    """Returns (x, aux_total, caches): ``caches`` (written in place, the
    same dict) when given, else None."""
    check_ported(mode, cfg)
    prefix, period, tail, n_periods = stack_structure(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layer(p, x, kind, cache):
        return apply_layer(p, x, cfg, kind, mode, positions=positions,
                           cache=cache, pos=pos, enc_out=enc_out,
                           causal=causal, table=table, lengths=lengths)

    def part(name, key):
        return caches[name][key] if caches is not None else None

    for i, kind in enumerate(prefix):
        x, aux, _ = run_layer(params["prefix"][f"l{i}"], x, kind,
                              part("prefix", f"l{i}"))
        aux_total = aux_total + aux

    if n_periods > 0:
        body = [params["body"][f"p{j}"] for j in range(len(period))]
        body_c = [part("body", f"p{j}") for j in range(len(period))]

        def period_fn(h, aux_acc, i):
            for j, kind in enumerate(period):
                c = tree_map(lambda l: l[i], body_c[j])
                h, aux, _ = run_layer(tree_map(lambda l: l[i], body[j]), h,
                                      kind, c)
                aux_acc = aux_acc + aux
            return h, aux_acc

        remat = cfg.remat and mode == "fwd" and torch.is_grad_enabled()
        for i in range(n_periods):
            if remat:
                x, aux_total = checkpoint(period_fn, x, aux_total, i,
                                          use_reentrant=False)
            else:
                x, aux_total = period_fn(x, aux_total, i)

    for i, kind in enumerate(tail):
        x, aux, _ = run_layer(params["tail"][f"l{i}"], x, kind,
                              part("tail", f"l{i}"))
        aux_total = aux_total + aux
    return x, aux_total, caches
