"""Full-sequence attention: grouped-query (+ qk-norm / bias, sliding
window), multi-head latent attention (MLA) and cross-attention.

Port of the full-sequence paths of the JAX package's
``models/attention.py``: ``init_attn``, ``init_mla``, the chunked
memory-efficient core with its FlashAttention-style backward,
``attn_forward``, ``mla_forward`` (expanded, or absorbed under
``cfg.mla_absorbed``) and ``cross_forward``. The forward
runs an online softmax over KV chunks, so live scores are O(Sq * chunk);
the backward (``_Flash.backward``) recomputes the probabilities per chunk
from ``(q, k, v, out, lse)``. Autograd through the chunk loop would keep
O(Sq * Sk) residuals, which the 4k training shape exists to avoid.

Under ``common.model_parallel`` (``distributed.sharding.tp_layout``) the
training forwards run on this rank's block of the query heads: GQA and
cross-attention with the KV heads those read, MLA with its latents
(``ql``, ``ckv``, ``k_pe``) computed whole on every rank and entering the
rank's heads through ``copy_to_model``; ``wo``'s rows are summed over the
model group. The serving paths run whole, as the reference serves under
no mesh.

This is plain PyTorch in the reference's order of operations: ``q`` scaled
by ``Dk ** -0.5`` in its storage dtype, scores and accumulators in
float32, masked scores at ``NEG_INF``, ``l`` floored at 1e-37, the output
cast to ``q``'s dtype. ``F.scaled_dot_product_attention`` would sum in
another order.

The serve half. Grouped-query attention: the dense decode cache of the
fixed-batch driver (``make_attn_cache``, ``attn_prefill``,
``attn_decode``; a ring buffer under a sliding window), and the paged KV
pools of the continuous engine (``make_paged_attn_cache``,
``attn_decode_paged``, ``attn_chunk_paged``, ``commit_prefill_pages``).
MLA: the dense latent cache of the fixed driver (``make_mla_cache``,
``mla_prefill``, ``mla_decode``, the weight-absorbed latent decode) and
the engine's per-lane latent rows (``make_mla_lane_cache``,
``mla_decode_lanes``, ``commit_prefill_mla``, ``mla_chunk_lanes``).
Where JAX returns new caches from ``.at[].set``, the port writes into the
caller's cache tensors in place (``index_copy_`` on flat views, indexed
assignment on the lane rows) and returns the same dict, so a decode step
copies no pool. Indices that ``jnp`` handles past an array's end are
clamped first, since torch raises there: a read past a page-table row
(``jnp`` clamps a gather, and fills ``take_along_axis`` with INT_MIN,
which the reference then masks), and a free lane's MLA write past its
row (``jnp`` drops an out-of-range scatter; the port writes the old value
back at the clamped slot).
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec
from .common import (apply_mrope, apply_rope, copy_to_model, dense_init, dot,
                     einsum, model_index, reduce_from_model, rms_norm,
                     split_width, zeros)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_attn(key, cfg: ModelConfig, cross: bool = False, device="cuda") -> Dict:
    d, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    ks = prng.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, H * D), cfg.dtype, device=device),
        "wk": dense_init(ks[1], (d, KV * D), cfg.dtype, device=device),
        "wv": dense_init(ks[2], (d, KV * D), cfg.dtype, device=device),
        "wo": dense_init(ks[3], (H * D, d), cfg.dtype, device=device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = zeros((H * D,), cfg.dtype, device)
        p["bk"] = zeros((KV * D,), cfg.dtype, device)
        p["bv"] = zeros((KV * D,), cfg.dtype, device)
    if cfg.qk_norm and not cross:
        p["qn"] = zeros((D,), cfg.dtype, device)
        p["kn"] = zeros((D,), cfg.dtype, device)
    return p


def init_mla(key, cfg: ModelConfig, device="cuda") -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, v, ql, kvl = (cfg.qk_nope, cfg.qk_rope, cfg.v_head_dim,
                              cfg.q_lora, cfg.kv_lora)
    ks = prng.split(key, 7)

    def dense(k, shape):
        return dense_init(k, shape, cfg.dtype, device=device)

    return {
        "wdq": dense(ks[0], (d, ql)),
        "qln": zeros((ql,), cfg.dtype, device),
        "wuq": dense(ks[1], (ql, H * (nope + rope))),
        "wdkv": dense(ks[2], (d, kvl)),
        "kvln": zeros((kvl,), cfg.dtype, device),
        "wuk": dense(ks[3], (kvl, H * nope)),
        "wuv": dense(ks[4], (kvl, H * v)),
        "wkr": dense(ks[5], (d, rope)),
        "wo": dense(ks[6], (H * v, d)),
    }


# ---------------------------------------------------------------------------
# chunked memory-efficient attention core
# ---------------------------------------------------------------------------


def _f32_einsum(eq: str, a, b):
    """``jnp.einsum(..., preferred_element_type=float32)``: the operands'
    products are exact in float32 (bf16 or f32 inputs), summed in float32."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _masked_scores(qg, kb, ci, chunk, Sk, Sq, causal, window, q_offset):
    s = _f32_einsum("bqkgd,bckd->bqkgc", qg, kb)
    dev = s.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = ci * chunk + torch.arange(chunk, device=dev)
    mask = (k_pos[None, :] < Sk).expand(Sq, chunk)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window and window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(mask[None, :, None, None, :], s,
                       torch.full((), NEG_INF, dtype=s.dtype, device=dev))


def _flash_chunks(k, v, chunk):
    """K/V zero-padded to whole chunks: (n, B, chunk, KV, D) each, and n."""
    B, Sk, KV, Dk = k.shape
    Dv = v.shape[-1]
    pad = (-Sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n = (Sk + pad) // chunk
    return (k.reshape(B, n, chunk, KV, Dk).transpose(0, 1),
            v.reshape(B, n, chunk, KV, Dv).transpose(0, 1), n)


def _scaled_q(q, KV):
    B, Sq, H, Dk = q.shape
    scale = torch.full((), Dk ** -0.5, dtype=q.dtype, device=q.device)
    return (q * scale).reshape(B, Sq, KV, H // KV, Dk)


def _flash_fwd_impl(q, k, v, causal, window, chunk, q_offset):
    B, Sq, H, Dk = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    f32 = torch.float32
    qg = _scaled_q(q, KV)
    kc, vc, n_chunks = _flash_chunks(k, v, chunk)

    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=f32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, Dv), dtype=f32, device=q.device)
    for ci in range(n_chunks):
        kb, vb = kc[ci], vc[ci]
        s = _masked_scores(qg, kb, ci, chunk, Sk, Sq, causal, window, q_offset)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _f32_einsum(
            "bqkgc,bckd->bqkgd", p.to(vb.dtype), vb)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-37)
    out = (acc / l_safe[..., None]).reshape(B, Sq, H, Dv).to(q.dtype)
    lse = m + torch.log(l_safe)
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, do, causal, window, chunk, q_offset):
    B, Sq, H, Dk = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    scale = Dk ** -0.5
    qg = _scaled_q(q, KV)
    dog = do.reshape(B, Sq, KV, G, Dv)
    outg = out.reshape(B, Sq, KV, G, Dv)
    delta = torch.sum(dog.to(torch.float32) * outg.to(torch.float32), dim=-1)
    kc, vc, n_chunks = _flash_chunks(k, v, chunk)

    dq = torch.zeros((B, Sq, KV, G, Dk), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ci in range(n_chunks):
        kb, vb = kc[ci], vc[ci]
        s = _masked_scores(qg, kb, ci, chunk, Sk, Sq, causal, window, q_offset)
        p = torch.exp(s - lse[..., None])                    # (B,Sq,KV,G,c)
        dvs.append(_f32_einsum("bqkgc,bqkgd->bckd", p.to(vb.dtype), dog))
        dp = _f32_einsum("bqkgd,bckd->bqkgc", dog, vb)
        ds = (p * (dp - delta[..., None])).to(kb.dtype)
        dq = dq + _f32_einsum("bqkgc,bckd->bqkgd", ds, kb) * scale
        dks.append(_f32_einsum("bqkgc,bqkgd->bckd", ds, qg))
    dk = torch.stack(dks, 1).reshape(B, n_chunks * chunk, KV, Dk)[:, :Sk]
    dv = torch.stack(dvs, 1).reshape(B, n_chunks * chunk, KV, Dv)[:, :Sk]
    return (dq.reshape(B, Sq, H, Dk).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0):
    """Memory-efficient attention. q: (B, Sq, H, Dk); k: (B, Sk, KV, Dk);
    v: (B, Sk, KV, Dv), H a multiple of KV. Returns (B, Sq, H, Dv) in q's
    dtype."""
    return _Flash.apply(q, k, v, causal, window, min(chunk, k.shape[1]),
                        q_offset)


# ---------------------------------------------------------------------------
# GQA full-sequence
# ---------------------------------------------------------------------------


def _qkv(p, x, cfg: ModelConfig):
    """(q, k, v) of ``x`` on the heads this rank computes: all of them, or
    under ``common.model_parallel`` its block of the query heads (``wq``'s
    columns, split by ``distributed.sharding.tp_layout``) and the KV heads
    those read (see ``_kv_heads``)."""
    D = cfg.head_dim
    H = p["wq"].shape[-1] // D
    if not split_width(p["wq"].shape[-1], cfg.n_heads * D, "attn/wq"):
        return _qkv_heads(p, x, cfg, H, cfg.n_kv)
    kv, KV = _kv_heads(p, cfg, H)
    ps = {**{n: p[n] for n in ("wq", "bq") if n in p}, **kv}
    for n in ("qn", "kn"):
        if n in p:      # one weight over every head: its gradient summed
            ps[n] = copy_to_model(p[n])
    return _qkv_heads(ps, copy_to_model(x), cfg, H, KV)


def _kv_heads(p, cfg: ModelConfig, H: int):
    """The K/V weights (and biases) of the KV heads this rank's ``H`` query
    heads read, and their count: ``wk``/``wv``'s blocks when ``tp_layout``
    split them, else the slice of the whole weights (read on every rank,
    their gradients summed over the model group) that GQA's head ``h ->
    h // (n_heads / n_kv)`` maps this rank's query heads to. Raises when
    those heads do not form equal groups over contiguous KV heads."""
    D, KV = cfg.head_dim, cfg.n_kv
    names = [n for n in ("wk", "wv", "bk", "bv") if n in p]
    if split_width(p["wk"].shape[-1], KV * D, "attn/wk"):
        return {n: p[n] for n in names}, p["wk"].shape[-1] // D
    G = cfg.n_heads // KV
    first = model_index() * H
    lo, hi = first // G, (first + H - 1) // G + 1
    if not (G % H == 0 or (H % G == 0 and first % G == 0)):
        raise ValueError(f"query heads {first}..{first + H - 1} read KV heads "
                         f"{lo}..{hi - 1} unevenly (groups of {G})")
    return ({n: copy_to_model(p[n]).narrow(-1, lo * D, (hi - lo) * D)
             for n in names}, hi - lo)


def _qkv_heads(p, x, cfg: ModelConfig, H: int, KV: int):
    B, S, d = x.shape
    D = cfg.head_dim
    q = dot(x, p["wq"])
    k = dot(x, p["wk"])
    v = dot(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, KV, D)
    v = v.reshape(B, S, KV, D)
    if "qn" in p:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, positions, cfg: ModelConfig):
    if cfg.rope_type == "mrope":
        if positions.ndim == q.ndim - 1:  # (B,S) text-only -> same pos 3x
            positions = positions[None].expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_base)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_base)
    else:
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    return q, k


def attn_forward(p, x, cfg: ModelConfig, *, kind: str, positions, causal=True):
    """Full-sequence self-attention ('attn' | 'attn_local')."""
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    window = cfg.window if kind == "attn_local" else 0
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            chunk=cfg.attn_chunk)
    out = out.reshape(x.shape[0], x.shape[1], -1)
    if split_width(p["wo"].shape[0], cfg.n_heads * cfg.head_dim, "attn/wo"):
        # a row split: this rank's heads' share of the output, summed in the
        # activation's dtype (where the reference's hint at
        # attention.py:350 puts the model axis back on the residual)
        return reduce_from_model(dot(out, p["wo"]))
    return dot(out, p["wo"])


# ---------------------------------------------------------------------------
# decode attention and the dense decode cache (fixed-batch driver)
# ---------------------------------------------------------------------------


def _softmax(s):
    """``jax.nn.softmax`` over the last axis in its order of operations:
    ``exp(s - max)`` divided by its sum (torch's softmax multiplies by the
    sum's reciprocal)."""
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _decode_core(q, k, v, valid):
    """One query per row over a cache: q (B,1,H,Dk); k/v (B,Sc,KV,D*);
    ``valid`` (B or 1, Sc) bool. Float32 scores, ``q`` scaled by
    ``Dk ** -0.5`` in float32, as the reference's decode attention."""
    B, _, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    qg = (q.to(torch.float32) * (Dk ** -0.5)).reshape(B, KV, G, Dk)
    s = _f32_einsum("bkgd,bckd->bkgc", qg, k)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    out = _f32_einsum("bkgc,bckd->bkgd", _softmax(s), v)
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def decode_attention(q, k, v, *, k_pos, pos, window: int = 0):
    """Single-token attention over a cache. q: (B, 1, H, Dk); k/v:
    (B, Sc, KV, D*); k_pos: (Sc,) stored absolute positions (-1 = empty
    slot); pos: the current position (an int or a 0-d tensor)."""
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window and window > 0:
        valid = valid & (k_pos > pos - window)
    return _decode_core(q, k, v, valid[None])


def decode_attention_lanes(q, k, v, *, k_pos, pos, window: int = 0):
    """Single-token attention where every lane sits at its own position:
    k_pos (B, Sc) logical positions per lane (-1 = empty slot), pos (B,)
    the position each lane writes this step."""
    valid = (k_pos >= 0) & (k_pos <= pos[:, None])
    if window and window > 0:
        valid = valid & (k_pos > (pos[:, None] - window))
    return _decode_core(q, k, v, valid)


def attn_prefill(p, x, cfg: ModelConfig, *, kind: str, positions, cache):
    """Full-sequence forward that also fills the dense KV cache (in place).
    A sliding-window cache shorter than the prompt keeps the last ``Sc``
    positions in ring order (slot = pos % Sc)."""
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    window = cfg.window if kind == "attn_local" else 0
    out = chunked_attention(q, k, v, causal=True, window=window,
                            chunk=cfg.attn_chunk)
    out = dot(out.reshape(x.shape[0], x.shape[1], -1), p["wo"])
    S = x.shape[1]
    Sc = cache["k"].shape[1]
    dt = cache["k"].dtype
    if Sc >= S:
        cache["k"][:, :S] = k.to(dt)
        cache["v"][:, :S] = v.to(dt)
        cache["pos"][:S] = torch.arange(S, dtype=torch.int32,
                                        device=cache["pos"].device)
    else:
        kpos = torch.arange(S - Sc, S, dtype=torch.int32, device=k.device)
        perm = torch.argsort(kpos % Sc)
        cache["k"].copy_(k[:, S - Sc:][:, perm].to(dt))
        cache["v"].copy_(v[:, S - Sc:][:, perm].to(dt))
        cache["pos"].copy_(kpos[perm])
    return out, cache


def attn_decode(p, x, cfg: ModelConfig, *, kind: str, pos, cache):
    """One-token decode at position ``pos`` (an int: every row of the
    batch writes the same slot). cache: {'k','v': (B,Sc,KV,D), 'pos':
    (Sc,)}, written in place."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    posb = torch.full((B, 1), int(pos), dtype=torch.int64, device=x.device)
    q, k = _rope_qk(q, k, posb, cfg)
    Sc = cache["k"].shape[1]
    slot = int(pos) % Sc  # ring when local; Sc >= S_max when global
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = int(pos)
    window = cfg.window if kind == "attn_local" else 0
    out = decode_attention(q, cache["k"], cache["v"], k_pos=cache["pos"],
                           pos=int(pos), window=window)
    return dot(out.reshape(B, 1, -1), p["wo"]), cache


def _cache_leaves(shapes, abstract: bool, device):
    if abstract:
        return {n: TensorSpec(s, dt, device) for n, (s, dt) in shapes.items()}
    return {n: torch.zeros(s, dtype=dt, device=device)
            for n, (s, dt) in shapes.items()}


def make_attn_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                    abstract=False, device="cuda"):
    Sc = (min(cfg.window, seq_len) if (kind == "attn_local" and cfg.window)
          else seq_len)
    KV, D = cfg.n_kv, cfg.head_dim
    c = _cache_leaves({"k": ((batch, Sc, KV, D), cfg.dtype),
                       "v": ((batch, Sc, KV, D), cfg.dtype),
                       "pos": ((Sc,), torch.int32)}, abstract, device)
    if not abstract:
        c["pos"].fill_(-1)
    return c


# ---------------------------------------------------------------------------
# paged KV cache (continuous-batching serve engine)
# ---------------------------------------------------------------------------
#
# The pool holds ``num_pages`` fixed-size pages shared by every lane; a page
# table row (per lane) maps logical slot j -> physical slot
# table[j // page_size] * page_size + j % page_size. Page 0 is reserved as a
# scratch page: free lanes point their whole table row at it, so their decode
# writes land in storage no active lane ever gathers.
#
# Scatters with repeated indices: ``index_copy_`` keeps an arbitrary writer
# of a repeated slot on CUDA. Two kinds of repeats occur, and both are
# harmless only while these facts hold: (1) free lanes, masked chunk tails
# and invalid ring slots all write the scratch page, which no live lane
# ever reads (its table row never maps a position it attends to page 0);
# (2) the engine pads a prefill batch by repeating its row 0, and those rows
# compute the same K/V from the same inputs, so every writer of their slots
# writes the same values.


def make_paged_attn_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                          abstract=False, device="cuda"):
    KV, D = cfg.n_kv, cfg.head_dim
    return _cache_leaves({"kp": ((num_pages, page_size, KV, D), cfg.dtype),
                          "vp": ((num_pages, page_size, KV, D), cfg.dtype)},
                         abstract, device)


def _flat(pool):
    """(P, page_size, KV, D) pool -> its (P * page_size, KV, D) view."""
    return pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])


def _gather_pages(flat, table, ps: int):
    """Every lane's pages in logical order: (B, T * ps, KV, D)."""
    B, T = table.shape
    gidx = (table[:, :, None] * ps
            + torch.arange(ps, device=table.device)[None, None, :]).reshape(B, T * ps)
    return flat[gidx]


def attn_decode_paged(p, x, cfg: ModelConfig, *, kind: str, pos, table, cache):
    """One-token decode against a paged KV pool.

    x: (B,1,d); pos: (B,) per-lane write position; table: (B,T) page table;
    cache: {'kp','vp': (P, page_size, KV, D)} shared pools. Writes this
    token's K/V into each lane's page slot, then gathers the lane's pages
    back into a (B, T*page_size, KV, D) view for ``decode_attention_lanes``.
    A free lane's position drifts past its (all-scratch) row: its page
    column is clamped to the row's last, as ``jnp`` clamps the read.
    """
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, pos[:, None], cfg)
    ps = cache["kp"].shape[1]
    kflat, vflat = _flat(cache["kp"]), _flat(cache["vp"])
    table, pos = table.long(), pos.long()
    T = table.shape[1]
    col = torch.clamp(pos // ps, max=T - 1)
    widx = table[torch.arange(B, device=x.device), col] * ps + pos % ps
    kflat.index_copy_(0, widx, k[:, 0].to(kflat.dtype))
    vflat.index_copy_(0, widx, v[:, 0].to(vflat.dtype))
    kl, vl = _gather_pages(kflat, table, ps), _gather_pages(vflat, table, ps)
    k_pos = torch.arange(T * ps, dtype=torch.int64, device=x.device)[None].expand(B, T * ps)
    window = cfg.window if kind == "attn_local" else 0
    out = decode_attention_lanes(q, kl, vl, k_pos=k_pos, pos=pos, window=window)
    return dot(out.reshape(B, 1, -1), p["wo"]), cache


def _chunk_attention(q, k, v, *, q_pos, k_pos, window: int = 0,
                     chunk: int = 1024):
    """Online-softmax attention with per-row masks, mirroring
    ``_flash_fwd_impl`` update for update (the same m/l/acc recurrence,
    einsums and casts). Masked keys contribute exactly zero
    (``exp(NEG_INF - m) == 0``), so over a key set whose valid subset is
    the dense path's, a one-chunk run gives the dense forward's bits: the
    identity the engine's batched and chunked prefill rides on.

    q: (B,Sq,H,Dk); k/v: (B,Sk,KV,D*); q_pos: (B,Sq) absolute positions of
    the queries; k_pos: (B,Sk) stored positions (-1 = empty/stale slot).
    """
    B, Sq, H, Dk = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    f32 = torch.float32
    chunk = min(chunk, Sk)
    qg = _scaled_q(q, KV)
    kc, vc, n_chunks = _flash_chunks(k, v, chunk)
    pad = (-Sk) % chunk
    if pad:
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    kpc = k_pos.reshape(B, n_chunks, chunk).transpose(0, 1)       # (n,B,chunk)
    neg = torch.full((), NEG_INF, dtype=f32, device=q.device)

    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=f32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, Dv), dtype=f32, device=q.device)
    for ci in range(n_chunks):
        kb, vb, kp = kc[ci], vc[ci], kpc[ci]
        s = _f32_einsum("bqkgd,bckd->bqkgc", qg, kb)
        mask = (kp[:, None, :] >= 0) & (kp[:, None, :] <= q_pos[:, :, None])
        if window and window > 0:
            mask = mask & (kp[:, None, :] > q_pos[:, :, None] - window)
        s = torch.where(mask[:, :, None, None, :], s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _f32_einsum(
            "bqkgc,bckd->bqkgd", p.to(vb.dtype), vb)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-37)
    return (acc / l_safe[..., None]).reshape(B, Sq, H, Dv).to(q.dtype)


def attn_chunk_paged(p, x, cfg: ModelConfig, *, kind: str, positions, lengths,
                     table, cache):
    """Batched bucketed/chunked prefill straight into the paged KV pools.

    x: (B,Cb,d) right-padded chunk batch; positions: (B,Cb) absolute
    positions (``start + j``); lengths: (B,) valid run per row; table: (B,T)
    page-table rows. Scatters the chunk's K/V into each row's pages first
    (padded slots land on the scratch page), then attends the chunk queries
    over the row's gathered logical view (earlier chunks and shared prefix
    pages included) under a ``k_pos <= q_pos`` mask, so one call serves
    plain bucketed prefill, chunk continuation and prefix-shared tails.
    The padded tail of a bucket can reach past the table's width: its page
    column is clamped before the read (the reference reads INT_MIN there)
    and masked to the scratch slot, as the reference masks it.
    """
    B, Cb, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    ps = cache["kp"].shape[1]
    kflat, vflat = _flat(cache["kp"]), _flat(cache["vp"])
    table, positions = table.long(), positions.long()
    T = table.shape[1]
    valid = (torch.arange(Cb, device=x.device)[None, :]
             < lengths.long()[:, None])
    page_of = torch.gather(table, 1, torch.clamp(positions // ps, max=T - 1))
    widx = torch.where(valid, page_of * ps + positions % ps,
                       torch.zeros((), dtype=torch.int64, device=x.device)).reshape(-1)
    kflat.index_copy_(0, widx, k.reshape(B * Cb, *k.shape[2:]).to(kflat.dtype))
    vflat.index_copy_(0, widx, v.reshape(B * Cb, *v.shape[2:]).to(vflat.dtype))
    kl, vl = _gather_pages(kflat, table, ps), _gather_pages(vflat, table, ps)
    k_pos = torch.arange(T * ps, dtype=torch.int64, device=x.device)[None].expand(B, T * ps)
    window = cfg.window if kind == "attn_local" else 0
    out = _chunk_attention(q, kl, vl, q_pos=positions, k_pos=k_pos,
                           window=window, chunk=cfg.attn_chunk)
    return dot(out.reshape(B, Cb, -1), p["wo"]), cache


def commit_prefill_pages(cache, dense, idx, *, stacked: bool):
    """Scatter a batch-1 dense prefill cache {'k','v','pos'} into the paged
    pools, in place. ``idx`` (S,) maps logical position j to its flat
    physical slot (page-table row expanded); the dense 'pos' leaf routes
    ring-ordered sliding-window caches (slot order != logical order,
    invalid slots = -1, which land on the scratch page). ``stacked`` marks
    body leaves carrying a leading period axis: every period layer saw the
    same positions, so one routing row serves the whole stack."""
    kp, vp = cache["kp"], cache["vp"]
    pos_leaf = (dense["pos"][0] if stacked else dense["pos"]).long()
    idx = idx.long().to(kp.device)
    valid = pos_leaf >= 0
    src = idx[torch.clamp(pos_leaf, 0, idx.shape[0] - 1)]
    tgt = torch.where(valid, src, torch.zeros((), dtype=torch.int64,
                                               device=src.device))
    if stacked:
        n, P, ps = kp.shape[0], kp.shape[1], kp.shape[2]
        kp.view(n, P * ps, *kp.shape[3:]).index_copy_(
            1, tgt, dense["k"][:, 0].to(kp.dtype))
        vp.view(n, P * ps, *vp.shape[3:]).index_copy_(
            1, tgt, dense["v"][:, 0].to(vp.dtype))
    else:
        _flat(kp).index_copy_(0, tgt, dense["k"][0].to(kp.dtype))
        _flat(vp).index_copy_(0, tgt, dense["v"][0].to(vp.dtype))
    return cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------


def _mla_split(p, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds this rank's block of MLA's query heads
    (``wuq``/``wuk``/``wuv`` columns, ``wo`` rows; ``tp_layout``)."""
    return split_width(p["wo"].shape[0], cfg.n_heads * cfg.v_head_dim,
                       "attn/wo")


def _mla_q(p, x, cfg: ModelConfig, positions):
    """(q_nope, q_pe) of this rank's heads. The query latent ``ql`` is
    computed whole on every rank; under a split it enters ``wuq``'s block
    through ``copy_to_model`` (each rank's heads give part of its
    gradient, so of ``wdq``'s and ``qln``'s)."""
    B, S, _ = x.shape
    nope, rope = cfg.qk_nope, cfg.qk_rope
    ql = rms_norm(dot(x, p["wdq"]), p["qln"], cfg.norm_eps)
    if split_width(p["wuq"].shape[-1], cfg.n_heads * (nope + rope),
                   "attn/wuq"):
        ql = copy_to_model(ql)
    q = dot(ql, p["wuq"]).reshape(B, S, -1, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_base)
    return q_nope, q_pe


def _mla_kv_latent(p, x, cfg: ModelConfig, positions):
    ckv = rms_norm(dot(x, p["wdkv"]), p["kvln"], cfg.norm_eps)  # (B,S,kvl)
    k_pe = apply_rope(dot(x, p["wkr"])[:, :, None, :], positions,
                      cfg.rope_base)[:, :, 0]
    return ckv, k_pe


def _mla_latents(p, x, cfg: ModelConfig, positions, split: bool):
    """(ckv, k_pe), whole on every rank; under a split each enters the
    rank's heads through ``copy_to_model``, so the gradients of ``wdkv``,
    ``kvln`` and ``wkr`` sum every rank's heads' parts."""
    ckv, k_pe = _mla_kv_latent(p, x, cfg, positions)
    if split:
        ckv, k_pe = copy_to_model(ckv), copy_to_model(k_pe)
    return ckv, k_pe


def _mla_out(p, out, split: bool):
    """``out @ wo``: under a split this rank's heads' share, summed over the
    model group (the reference's hints at attention.py:619 and :640)."""
    y = dot(out, p["wo"])
    return reduce_from_model(y) if split else y


def mla_forward(p, x, cfg: ModelConfig, *, positions, causal=True):
    """Train/prefill MLA, in one of two forms of the same math: expanded
    (per-head K/V materialized from the latent) or, under
    ``cfg.mla_absorbed``, absorbed (attention directly against the shared
    latent ``c_kv ++ k_pe``, one KV head). Under ``common.model_parallel``
    on this rank's block of the heads (``_mla_split``)."""
    if cfg.mla_absorbed:
        return _mla_forward_absorbed(p, x, cfg, positions=positions,
                                     causal=causal)
    B, S, _ = x.shape
    nope, v_dim = cfg.qk_nope, cfg.v_head_dim
    split = _mla_split(p, cfg)
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    H = q_nope.shape[2]
    ckv, k_pe = _mla_latents(p, x, cfg, positions, split)
    k_nope = dot(ckv, p["wuk"]).reshape(B, S, H, nope)
    v = dot(ckv, p["wuv"]).reshape(B, S, H, v_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, cfg.qk_rope)],
                  dim=-1)
    out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return _mla_out(p, out.reshape(B, S, H * v_dim), split)


def _mla_forward_absorbed(p, x, cfg: ModelConfig, *, positions, causal=True):
    B, S, _ = x.shape
    nope, v_dim, kvl, rope = (cfg.qk_nope, cfg.v_head_dim, cfg.kv_lora,
                              cfg.qk_rope)
    split = _mla_split(p, cfg)
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    H = q_nope.shape[2]
    # the shared latent is every head's K/V: under a split it enters this
    # rank's heads once, through ``copy_to_model``
    ckv, k_pe = _mla_latents(p, x, cfg, positions, split)
    wuk = p["wuk"].reshape(kvl, H, nope)
    q_lat = einsum("bqhn,khn->bqhk", q_nope, wuk)             # (B,S,H,kvl)
    # flash scales by (kvl+rope)^-1/2; the true scale is (nope+rope)^-1/2
    fix = ((kvl + rope) / (nope + rope)) ** 0.5
    q = torch.cat([q_lat, q_pe], dim=-1)
    q = q * torch.full((), fix, dtype=q_lat.dtype, device=q.device)
    k = torch.cat([ckv, k_pe], dim=-1)[:, :, None, :]          # (B,S,1,kvl+r)
    v = ckv[:, :, None, :]                                     # (B,S,1,kvl)
    o_lat = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    wuv = p["wuv"].reshape(kvl, H, v_dim)
    out = einsum("bqhk,khv->bqhv", o_lat, wuv)
    return _mla_out(p, out.reshape(B, S, H * v_dim), split)


def mla_prefill(p, x, cfg: ModelConfig, *, positions, cache):
    """Full-sequence MLA that also fills the dense latent cache in place.
    The reference's ``dynamic_update_slice`` clamps its start; the fixed
    driver sizes the cache for the prompt and the generation, so the
    prompt's slots [0, S) always fit and a slice assignment is exact."""
    out = mla_forward(p, x, cfg, positions=positions)
    ckv, k_pe = _mla_kv_latent(p, x, cfg, positions)
    S = x.shape[1]
    cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
    cache["kpe"][:, :S] = k_pe.to(cache["kpe"].dtype)
    cache["pos"][:S] = torch.arange(S, dtype=torch.int32,
                                    device=cache["pos"].device)
    return out, cache


def _mla_latent_decode(p, x, cfg: ModelConfig, q_nope, q_pe, ckv, kpe,
                       valid):
    """Weight-absorbed one-token attention on the latent cache: q_nope
    (B,1,H,nope), q_pe (B,1,H,rope), ckv (B,S,kvl), kpe (B,S,rope), valid
    (B or 1, S). Float32 throughout, as the reference's decode."""
    B = x.shape[0]
    H, nope, v_dim, kvl = cfg.n_heads, cfg.qk_nope, cfg.v_head_dim, cfg.kv_lora
    f32 = torch.float32
    wuk = p["wuk"].reshape(kvl, H, nope)
    # absorb W_uk into the query: (B,1,H,kvl)
    q_lat = _f32_einsum("bqhn,khn->bqhk", q_nope, wuk)
    scale = (nope + cfg.qk_rope) ** -0.5
    s = (_f32_einsum("bqhk,bsk->bhqs", q_lat, ckv)
         + _f32_einsum("bqhr,bsr->bhqs", q_pe, kpe))
    s = s * scale
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, dtype=f32, device=s.device))
    o_lat = _f32_einsum("bhqs,bsk->bqhk", _softmax(s), ckv)        # (B,1,H,kvl)
    wuv = p["wuv"].reshape(kvl, H, v_dim)
    out = _f32_einsum("bqhk,khv->bqhv", o_lat, wuv)
    return dot(out.reshape(B, 1, H * v_dim).to(x.dtype), p["wo"])


def mla_decode(p, x, cfg: ModelConfig, *, pos, cache):
    """One-token latent decode at position ``pos`` (an int, the same for
    every row) on the dense latent cache, written in place. The fixed
    driver never decodes past the cache, so the slot is in range."""
    B = x.shape[0]
    posb = torch.full((B, 1), int(pos), dtype=torch.int64, device=x.device)
    q_nope, q_pe = _mla_q(p, x, cfg, posb)            # (B,1,H,nope),(B,1,H,rope)
    ckv_t, kpe_t = _mla_kv_latent(p, x, cfg, posb)    # (B,1,kvl),(B,1,rope)
    cache["ckv"][:, int(pos)] = ckv_t[:, 0].to(cache["ckv"].dtype)
    cache["kpe"][:, int(pos)] = kpe_t[:, 0].to(cache["kpe"].dtype)
    cache["pos"][int(pos)] = int(pos)
    kpos = cache["pos"]
    valid = (kpos >= 0) & (kpos <= int(pos))
    return _mla_latent_decode(p, x, cfg, q_nope, q_pe, cache["ckv"],
                              cache["kpe"], valid[None]), cache


def make_mla_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   abstract=False, device="cuda"):
    c = _cache_leaves({"ckv": ((batch, seq_len, cfg.kv_lora), cfg.dtype),
                       "kpe": ((batch, seq_len, cfg.qk_rope), cfg.dtype),
                       "pos": ((seq_len,), torch.int32)}, abstract, device)
    if not abstract:
        c["pos"].fill_(-1)
    return c


def make_mla_lane_cache(cfg: ModelConfig, lanes: int, max_len: int,
                        abstract=False, device="cuda"):
    """Per-lane dense latent rows for the serve engine (the latent is
    already ~20x smaller than expanded K/V, so lanes stay dense); the
    position row is per lane, so a reused lane can invalidate its stale
    slots."""
    c = _cache_leaves({"ckv": ((lanes, max_len, cfg.kv_lora), cfg.dtype),
                       "kpe": ((lanes, max_len, cfg.qk_rope), cfg.dtype),
                       "pos": ((lanes, max_len), torch.int32)},
                      abstract, device)
    if not abstract:
        c["pos"].fill_(-1)
    return c


def mla_decode_lanes(p, x, cfg: ModelConfig, *, pos, cache, live=None):
    """Weight-absorbed latent decode with per-lane positions ``pos`` (B,),
    writing each lane's slot of its row in place.

    A free lane's position drifts past its row (the engine advances every
    lane): ``jnp`` drops that out-of-range write, torch would raise, so the
    slot is clamped to the row's last and the old value written back there.
    ``live`` (B,) holds the idle lanes' rows (the reference's ``hold_idle``
    in ``blocks.apply_layer``): after the attention, which sees this step's
    writes in every lane as the reference's does, an idle lane's slot gets
    its old value back. A decode step changes one slot per lane, so that
    is the whole row's ``where(live, new, old)``."""
    B = x.shape[0]
    posb = pos.long()[:, None]
    q_nope, q_pe = _mla_q(p, x, cfg, posb)
    ckv_t, kpe_t = _mla_kv_latent(p, x, cfg, posb)
    L = cache["ckv"].shape[1]
    bidx = torch.arange(B, device=x.device)
    pos = pos.long()
    tgt = torch.clamp(pos, max=L - 1)
    keep = pos < L
    leaves = (("ckv", ckv_t[:, 0]), ("kpe", kpe_t[:, 0]), ("pos", pos))
    old = {n: cache[n][bidx, tgt] for n, _ in leaves}         # copies
    for n, new in leaves:
        m = keep.view(-1, *([1] * (new.dim() - 1)))
        cache[n][bidx, tgt] = torch.where(m, new.to(cache[n].dtype), old[n])
    valid = (cache["pos"] >= 0) & (cache["pos"] <= pos[:, None])
    out = _mla_latent_decode(p, x, cfg, q_nope, q_pe, cache["ckv"],
                             cache["kpe"], valid)
    if live is not None:
        for n, _ in leaves:
            m = live.to(torch.bool).view(-1, *([1] * (old[n].dim() - 1)))
            cache[n][bidx, tgt] = torch.where(m, cache[n][bidx, tgt], old[n])
    return out, cache


def commit_prefill_mla(cache, dense, lane, *, stacked: bool):
    """Write a batch-1 dense MLA prefill cache into one lane's row, in
    place, stamping -1 into the position slots past it so a reused lane
    never attends to its previous occupant's cache."""
    S = dense["ckv"].shape[-2]
    L = cache["pos"].shape[-1]
    ar = torch.arange(L, dtype=torch.int32, device=cache["pos"].device)
    row_pos = torch.where(ar < S, ar, torch.full((), -1, dtype=torch.int32,
                                                 device=ar.device))
    if stacked:
        cache["ckv"][:, lane, :S] = dense["ckv"][:, 0].to(cache["ckv"].dtype)
        cache["kpe"][:, lane, :S] = dense["kpe"][:, 0].to(cache["kpe"].dtype)
        cache["pos"][:, lane] = row_pos[None]
    else:
        cache["ckv"][lane, :S] = dense["ckv"][0].to(cache["ckv"].dtype)
        cache["kpe"][lane, :S] = dense["kpe"][0].to(cache["kpe"].dtype)
        cache["pos"][lane] = row_pos
    return cache


def mla_chunk_lanes(p, x, cfg: ModelConfig, *, positions, lengths, lanes,
                    cache):
    """Batched bucketed/chunked MLA prefill into per-lane latent rows.

    ``mla_forward``'s math (absorbed or expanded, per config) over the
    lane's stored latent rows: the chunk's (c_kv, k_pe) are written at
    their absolute positions first (a padded slot, clipped to the row's
    last, writes its old value back), the position row is stamped ``j if j
    < start+length else -1`` (idempotent across chunks; it invalidates a
    reused lane's stale slots), then the chunk's queries attend over the
    whole row under the stored-position mask through ``_chunk_attention``.
    A batch padded by repeating its row 0 repeats that row's lane and
    slots with the same values."""
    B, Cb, _ = x.shape
    H, nope, v_dim, kvl, rope = (cfg.n_heads, cfg.qk_nope, cfg.v_head_dim,
                                 cfg.kv_lora, cfg.qk_rope)
    positions, lanes = positions.long(), lanes.long()
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    ckv_t, kpe_t = _mla_kv_latent(p, x, cfg, positions)
    L = cache["ckv"].shape[1]
    valid = (torch.arange(Cb, device=x.device)[None, :]
             < lengths.long()[:, None])
    tgt = torch.clamp(positions, 0, L - 1)                        # (B,Cb)
    bl = lanes[:, None]
    for n, new in (("ckv", ckv_t), ("kpe", kpe_t)):
        old = cache[n][bl, tgt]                                   # a copy
        cache[n][bl, tgt] = torch.where(valid[..., None],
                                        new.to(cache[n].dtype), old)
    ar = torch.arange(L, device=x.device)[None, :]
    limit = (positions[:, 0] + lengths.long())[:, None]           # start+length
    row_pos = torch.where(ar < limit, ar, torch.full((), -1, dtype=ar.dtype,
                                                     device=ar.device))
    cache["pos"][lanes] = row_pos.to(cache["pos"].dtype)

    ckv_rows = cache["ckv"][lanes]                                # (B,L,kvl)
    kpe_rows = cache["kpe"][lanes]                                # (B,L,rope)
    if cfg.mla_absorbed:
        wuk = p["wuk"].reshape(kvl, H, nope)
        q_lat = einsum("bqhn,khn->bqhk", q_nope, wuk)
        fix = ((kvl + rope) / (nope + rope)) ** 0.5
        q = torch.cat([q_lat, q_pe], dim=-1)
        q = q * torch.full((), fix, dtype=q_lat.dtype, device=q.device)
        kk = torch.cat([ckv_rows, kpe_rows], dim=-1)[:, :, None, :]
        vv = ckv_rows[:, :, None, :]
        o_lat = _chunk_attention(q, kk, vv, q_pos=positions, k_pos=row_pos,
                                 chunk=cfg.attn_chunk)
        wuv = p["wuv"].reshape(kvl, H, v_dim)
        out = einsum("bqhk,khv->bqhv", o_lat, wuv)
    else:
        k_nope = dot(ckv_rows, p["wuk"]).reshape(B, L, H, nope)
        vv = dot(ckv_rows, p["wuv"]).reshape(B, L, H, v_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        kk = torch.cat([k_nope, kpe_rows[:, :, None, :].expand(B, L, H, rope)],
                       dim=-1)
        out = _chunk_attention(q, kk, vv, q_pos=positions, k_pos=row_pos,
                               chunk=cfg.attn_chunk)
    return dot(out.reshape(B, Cb, H * v_dim), p["wo"]), cache


# ---------------------------------------------------------------------------
# cross-attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_forward(p, x, enc_out, cfg: ModelConfig):
    """The decoder's queries over the encoder's output. Under
    ``common.model_parallel``, as ``attn_forward``: this rank's query heads
    and the KV heads they read (``_kv_heads``), ``x`` and ``enc_out``
    entering through ``copy_to_model``, ``wo``'s rows summed over the model
    group."""
    B, S, _ = x.shape
    D = cfg.head_dim
    H = p["wq"].shape[-1] // D
    Se = enc_out.shape[1]
    split = split_width(p["wq"].shape[-1], cfg.n_heads * D, "cross/wq")
    if split:
        kv, KV = _kv_heads(p, cfg, H)
        x, enc_out = copy_to_model(x), copy_to_model(enc_out)
    else:
        kv, KV = p, cfg.n_kv
    q = dot(x, p["wq"]).reshape(B, S, H, D)
    k = dot(enc_out, kv["wk"]).reshape(B, Se, KV, D)
    v = dot(enc_out, kv["wv"]).reshape(B, Se, KV, D)
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    y = dot(out.reshape(B, S, H * D), p["wo"])
    return reduce_from_model(y) if split else y
