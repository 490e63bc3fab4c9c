"""The dense MLP and the Mixture-of-Experts FFN: top-k routing with
capacity-based dispatch.

Port of the JAX package's ``models/moe.py``. The default dispatch is the
GShard/Switch einsum form: tokens are grouped, given expert-buffer slots by
an intra-group cumsum, and moved with one-hot dispatch/combine einsums.
``n_tok <= 256`` takes the exact per-token weight gather, and
``moe_impl="ragged"`` sorts the (token, slot) pairs by expert and runs one
product per expert over its contiguous rows (the reference's
``jax.lax.ragged_dot``). DeepSeek-style shared experts add an always-on
dense branch. Under ``common.model_parallel`` the dense FFN, the routed
experts and the shared experts each run on this rank's block of their
hidden units (``distributed.sharding.tp_layout``) and sum their output
over the model group; the router runs whole on every rank.

Integer routing matches the reference bit for bit: top-k is a stable
descending sort (``jax.lax.top_k`` returns the lower index first on ties;
``torch.topk`` promises no order), so expert ids, capacity slots and the
dispatch mask are the reference's. The ragged path needs the group sizes
on the host (one sync per MoE layer), and adds each token's k expert
outputs in a fixed order, by expert id, as the reference's scatter-add
adds them. Every path sums in a fixed order forward and backward, on
every device: the gather path reads expert rows through
``common.take_rows``, and every other read by index names each row at
most once (``_permute``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ModelConfig
from .common import (activation, copy_to_model, data_mean, data_size,
                     dense_init, dot, einsum, reduce_from_model, split_width,
                     take_rows)


def init_mlp(key, cfg: ModelConfig, device="cuda") -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 3)
    p = {
        "wi": dense_init(ks[0], (d, ff), cfg.dtype, device=device),
        "wo": dense_init(ks[1], (ff, d), cfg.dtype, fan_in=ff, device=device),
    }
    if cfg.glu:
        p["wg"] = dense_init(ks[2], (d, ff), cfg.dtype, device=device)
    return p


def mlp_forward(p, x, cfg: ModelConfig):
    """The dense FFN. Under ``common.model_parallel`` with ``wi``/``wg``'s
    column blocks and ``wo``'s row block (``tp_layout``), this rank's
    share of the hidden units, summed over the model group (the cut the
    reference hints at moe.py:194)."""
    return _ffn(p, x, cfg, ("wi", "wg", "wo"), cfg.d_ff, "mlp")


def _ffn(p, x, cfg: ModelConfig, names, width: int, what: str):
    """``act(x @ wi) [* x @ wg] @ wo`` over ``p[names]``, each rank on its
    block of the ``width`` hidden units when they are split."""
    wi, wg, wo = names
    split = split_width(p[wi].shape[-1], width, f"{what}/{wi}")
    if split:
        x = copy_to_model(x)
    h = dot(x, p[wi])
    if cfg.glu:
        h = activation(h, cfg.activation) * dot(x, p[wg])
    else:
        h = activation(h, cfg.activation)
    y = dot(h, p[wo])
    return reduce_from_model(y) if split else y


# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------


def init_moe(key, cfg: ModelConfig, device="cuda") -> Dict:
    d = cfg.d_model
    ff = cfg.d_ff_expert or cfg.d_ff
    E = cfg.n_experts
    ks = prng.split(key, 7)
    p = {
        "router": dense_init(ks[0], (d, E), torch.float32, device=device),
        "wi": dense_init(ks[1], (E, d, ff), cfg.dtype, device=device),
        "wo": dense_init(ks[2], (E, ff, d), cfg.dtype, fan_in=ff, device=device),
    }
    if cfg.glu:
        p["wg"] = dense_init(ks[3], (E, d, ff), cfg.dtype, device=device)
    if cfg.n_shared:
        sff = ff * cfg.n_shared
        p["swi"] = dense_init(ks[4], (d, sff), cfg.dtype, device=device)
        p["swo"] = dense_init(ks[5], (sff, d), cfg.dtype, fan_in=sff,
                              device=device)
        if cfg.glu:
            p["swg"] = dense_init(ks[6], (d, sff), cfg.dtype, device=device)
    return p


def _expert_ffn(p, xe, cfg: ModelConfig):
    """xe: (..., E, C, d) expert buffers -> (..., E, C, d)."""
    h = einsum("...ecd,edf->...ecf", xe, p["wi"])
    if cfg.glu:
        h = activation(h, cfg.activation) * einsum("...ecd,edf->...ecf", xe,
                                                   p["wg"])
    else:
        h = activation(h, cfg.activation)
    return einsum("...ecf,efd->...ecd", h, p["wo"])


def _shared_ffn(p, x, cfg: ModelConfig):
    return _ffn(p, x, cfg, ("swi", "swg", "swo"),
                (cfg.d_ff_expert or cfg.d_ff) * cfg.n_shared, "moe")


def top_k(x, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_size(n_tok: int, moe_group: int) -> int:
    """The largest divisor of ``n_tok`` that fits the configured group."""
    g = min(moe_group, n_tok)
    while n_tok % g:
        g -= 1
    return g


def route(p, xt, cfg: ModelConfig):
    """xt: (ng, g, d) -> (probs, gate_vals, gate_idx, aux): the f32 router's
    softmax, the top-k gates renormalised to sum to 1, their expert ids,
    and the Switch load-balance loss E * sum(frac_tokens * frac_prob),
    its two fractions over the global batch (``common.data_mean``)."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)   # (ng,g,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                              # (ng,g,k)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, -1, keepdim=True), 1e-9)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(gate_idx[..., 0], E).to(torch.float32),
                    dim=(0, 1))
    if data_size() > 1:
        me, ce = data_mean(torch.cat([me, ce])).split(E)
    aux = E * torch.sum(me * ce)
    return probs, gate_vals, gate_idx, aux


def capacity_slots(gate_vals, gate_idx, E: int, capacity: int):
    """The einsum dispatch's (combine, dispatch mask), both (ng, g, E, C):
    slot j of every token takes the next free position of its expert in
    its group, after the slots before j of every token; a token past
    ``capacity`` is dropped for that expert."""
    ng, g, k = gate_idx.shape
    f32 = torch.float32
    combine = torch.zeros((ng, g, E, capacity), dtype=f32,
                          device=gate_vals.device)
    prior = torch.zeros((ng, 1, E), dtype=f32, device=gate_vals.device)
    for j in range(k):
        oh = F.one_hot(gate_idx[..., j], E).to(f32)                     # (ng,g,E)
        pos_in_e = torch.cumsum(oh, dim=1) - 1.0 + prior                # (ng,g,E)
        keep = (pos_in_e < capacity).to(f32) * oh
        prior = prior + torch.sum(oh, dim=1, keepdim=True)
        pos_clip = torch.clamp(torch.sum(pos_in_e * oh, -1), 0, capacity - 1)
        sel = F.one_hot(pos_clip.to(torch.int64), capacity).to(f32)
        combine = combine + (gate_vals[..., j, None, None] * keep[..., None]
                             * sel[..., None, :])
    return combine, combine > 0.0


def moe_forward(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Under ``common.data_parallel`` ``x``
    is this rank's rows of the global batch: the group size, the capacity
    and the choice of the gather path are the global batch's, and a group
    may not span two ranks' rows."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_tok = B * S
    n_global = n_tok * data_size()
    g = group_size(n_global, cfg.moe_group)
    if n_tok % g:
        raise ValueError(
            f"MoE groups of {g} tokens (of {n_global} over {data_size()} "
            f"ranks) span two ranks' {n_tok} tokens")
    ng = n_tok // g
    xt = x.reshape(ng, g, d)
    _, gate_vals, gate_idx, aux = route(p, xt, cfg)
    # the routed experts on this rank's block of each expert's ffn dim
    # (``tp_layout``): the router runs whole on every rank, the experts'
    # input and gates enter the split region, each token's combined
    # output is summed over the model group
    split = split_width(p["wi"].shape[-1], cfg.d_ff_expert or cfg.d_ff,
                        "moe/wi")
    xs = copy_to_model(xt) if split else xt
    gates = copy_to_model(gate_vals) if split else gate_vals

    if n_global <= 256:
        # decode / tiny batches: exact per-token expert-weight gather
        y = _gather_moe(p, xs.reshape(n_tok, d), gates.reshape(n_tok, k),
                        gate_idx.reshape(n_tok, k), cfg).reshape(ng, g, d)
    elif cfg.moe_impl == "einsum":
        capacity = int(max(1, round(cfg.capacity_factor * g * k / E)))
        combine, mask = capacity_slots(gates, gate_idx, E, capacity)
        dispatch = mask.to(xt.dtype)                                    # (ng,g,E,C)
        xe = einsum("ngec,ngd->necd", dispatch, xs)                     # (ng,E,C,d)
        ye = _expert_ffn(p, xe, cfg)                                    # (ng,E,C,d)
        y = einsum("ngec,necd->ngd", combine.to(xt.dtype), ye)
    elif cfg.moe_impl == "ragged":
        y = _ragged_moe(p, xs, gates, gate_idx, cfg)
    else:
        raise ValueError(cfg.moe_impl)
    if split:
        y = reduce_from_model(y)

    if cfg.n_shared:
        y = y + _shared_ffn(p, xt, cfg)
    return y.reshape(B, S, d), aux.to(torch.float32)


def _permute(a, idx):
    """``a[idx]`` along axis 0 for an ``idx`` that names every row at most
    once: the backward (``index_add_``) then never adds twice to one row,
    so it is exact and needs no order."""
    return a.index_select(0, idx)


def _select_experts(w, gate_idx):
    """``w[gate_idx]`` for (n, k) expert ids: rows of the stack read as a
    2-D table through ``take_rows``, so the weight's gradient sums each
    expert's rows in a fixed order on either device."""
    rows = take_rows(w.reshape(w.shape[0], -1), gate_idx)
    return rows.reshape(*gate_idx.shape, *w.shape[1:])


def _gather_moe(p, x, gate_vals, gate_idx, cfg: ModelConfig):
    """x: (n, d); per-token expert weight gather. Exact (no capacity)."""
    wi = _select_experts(p["wi"], gate_idx)                # (n, k, d, ff)
    wo = _select_experts(p["wo"], gate_idx)                # (n, k, ff, d)
    h = einsum("nd,nkdf->nkf", x, wi)
    if cfg.glu:
        h = activation(h, cfg.activation) * einsum(
            "nd,nkdf->nkf", x, _select_experts(p["wg"], gate_idx))
    else:
        h = activation(h, cfg.activation)
    y = einsum("nkf,nkfd->nkd", h, wo)
    return einsum("nkd,nk->nd", y, gate_vals.to(y.dtype))


def _grouped_dot(xs, w, sizes):
    """``jax.lax.ragged_dot``: rows of ``xs`` in consecutive groups of
    ``sizes`` (host ints), group e times ``w[e]``."""
    outs, start = [], 0
    for e, n in enumerate(sizes):
        outs.append(dot(xs[start:start + n], w[e]))
        start += n
    return torch.cat(outs, 0)


def _ragged_moe(p, xt, gate_vals, gate_idx, cfg: ModelConfig):
    """Sort-based grouped-matmul path (exact FLOPs): every token repeated k
    times, the copies sorted by expert id (stable), one product per expert
    over its contiguous rows; each token's k outputs then added in sorted
    order, as the reference's scatter-add adds them."""
    ng, g, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    n = ng * g
    x_flat = xt.reshape(n, d)
    e_flat = gate_idx.reshape(-1)
    w_flat = gate_vals.reshape(-1).to(xt.dtype)
    order = torch.argsort(e_flat, stable=True)
    # every token k times (jnp.repeat), then sorted: the copies' gradients
    # add up in expand's backward, a reduction in a fixed order
    xs = _permute(x_flat[:, None].expand(n, k, d).reshape(n * k, d), order)
    # host sync: the ragged dispatch cuts the rows by expert on the host
    sizes = torch.bincount(e_flat, minlength=E).tolist()  # graphlint: allow (no grouped GEMM takes device sizes)

    h = _grouped_dot(xs, p["wi"], sizes)
    if cfg.glu:
        h = activation(h, cfg.activation) * _grouped_dot(xs, p["wg"], sizes)
    else:
        h = activation(h, cfg.activation)
    ye = _grouped_dot(h, p["wo"], sizes) * _permute(w_flat, order)[:, None]
    # each token's k rows of ye, in sorted order (its experts ascending)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n * k, device=order.device)
    rows = torch.sort(rank.reshape(n, k), dim=1).values
    y = _permute(ye, rows[:, 0])
    for j in range(1, k):
        y = y + _permute(ye, rows[:, j])
    return y.reshape(ng, g, d)
