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

This is plain PyTorch in the reference's order of operations: ``q`` scaled
by ``Dk ** -0.5`` in its storage dtype, scores and accumulators in
float32, masked scores at ``NEG_INF``, ``l`` floored at 1e-37, the output
cast to ``q``'s dtype. ``F.scaled_dot_product_attention`` would sum in
another order. The decode / prefill / paged paths come with serving.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import prng
from ..configs.base import ModelConfig
from .common import (apply_mrope, apply_rope, dense_init, dot, einsum,
                     rms_norm, zeros)

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
    B, S, d = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
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
    return dot(out.reshape(x.shape[0], x.shape[1], -1), p["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------


def _mla_q(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, nope, rope = cfg.n_heads, cfg.qk_nope, cfg.qk_rope
    ql = rms_norm(dot(x, p["wdq"]), p["qln"], cfg.norm_eps)
    q = dot(ql, p["wuq"]).reshape(B, S, H, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_base)
    return q_nope, q_pe


def _mla_kv_latent(p, x, cfg: ModelConfig, positions):
    ckv = rms_norm(dot(x, p["wdkv"]), p["kvln"], cfg.norm_eps)  # (B,S,kvl)
    k_pe = apply_rope(dot(x, p["wkr"])[:, :, None, :], positions,
                      cfg.rope_base)[:, :, 0]
    return ckv, k_pe


def mla_forward(p, x, cfg: ModelConfig, *, positions, causal=True):
    """Train/prefill MLA, in one of two forms of the same math: expanded
    (per-head K/V materialized from the latent) or, under
    ``cfg.mla_absorbed``, absorbed (attention directly against the shared
    latent ``c_kv ++ k_pe``, one KV head)."""
    if cfg.mla_absorbed:
        return _mla_forward_absorbed(p, x, cfg, positions=positions,
                                     causal=causal)
    B, S, _ = x.shape
    H, nope, v_dim = cfg.n_heads, cfg.qk_nope, cfg.v_head_dim
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    ckv, k_pe = _mla_kv_latent(p, x, cfg, positions)
    k_nope = dot(ckv, p["wuk"]).reshape(B, S, H, nope)
    v = dot(ckv, p["wuv"]).reshape(B, S, H, v_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, cfg.qk_rope)],
                  dim=-1)
    out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return dot(out.reshape(B, S, H * v_dim), p["wo"])


def _mla_forward_absorbed(p, x, cfg: ModelConfig, *, positions, causal=True):
    B, S, _ = x.shape
    H, nope, v_dim, kvl, rope = (cfg.n_heads, cfg.qk_nope, cfg.v_head_dim,
                                 cfg.kv_lora, cfg.qk_rope)
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    ckv, k_pe = _mla_kv_latent(p, x, cfg, positions)
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
    return dot(out.reshape(B, S, H * v_dim), p["wo"])


# ---------------------------------------------------------------------------
# cross-attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_forward(p, x, enc_out, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
    Se = enc_out.shape[1]
    q = dot(x, p["wq"]).reshape(B, S, H, D)
    k = dot(enc_out, p["wk"]).reshape(B, Se, KV, D)
    v = dot(enc_out, p["wv"]).reshape(B, Se, KV, D)
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return dot(out.reshape(B, S, H * D), p["wo"])
