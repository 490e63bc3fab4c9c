"""Shared model building blocks: inits, norms, activations, RoPE/M-RoPE and
the token cross-entropy.

Port of the JAX package's ``models/common.py``. Models are functional:
``init(key, cfg, device) -> params`` (nested dicts of tensors) and pure
apply functions; parameter names are the reference's (``stack/body/p0/
attn/wq``), so analog plans, sharding templates and checkpoints select the
same paths in both packages. Initializers draw through ``repro_torch.prng``
as ``jax.random`` draws, in float32, then cast to the config's dtype.

The reference's sharding hints (``constrain``, ``constrain_attention_q``,
``set_shard_rules``) are the identity without a mesh, and the port has no
mesh yet, so they are left out.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import prng
from ..kernels.ref import div

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _meta(device) -> bool:
    """On the meta device an initializer draws nothing: its result only
    carries a shape and a dtype (``LM.abstract_params``)."""
    return torch.device(device).type == "meta"


def dense_init(key, shape: Sequence[int], dtype, fan_in: Optional[int] = None,
               device="cuda"):
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fi = fan_in if fan_in is not None else shape[0]
    std = fi ** -0.5
    return (std * prng.truncated_normal(key, -2.0, 2.0, shape, device)).to(dtype)


def embed_init(key, shape, dtype, device="cuda"):
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return prng.normal(key, shape, device).to(dtype)


def zeros(shape, dtype, device="cuda"):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def dot(a, b):
    """``a @ b`` in the promoted dtype of the two, as ``jnp`` promotes (a
    float32 activation times a bfloat16 analog weight is a float32
    product); torch's ``@`` refuses mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def take_rows(table, ids):
    """``table[ids]`` (rows of a 2-D table), with a backward that sums each
    row's gradients in a fixed order on either device: on CUDA an indexed
    read (its ``index_put_`` sorts the ids first; ``F.embedding``'s
    backward is not bit-reproducible there), on the CPU ``F.embedding``
    (an indexed read's ``index_put_`` adds in parallel there)."""
    if table.is_cuda:
        return table[ids]
    return F.embedding(ids, table)


def einsum(eq: str, *ops):
    """``torch.einsum`` in the promoted dtype of its operands, as
    ``jnp.einsum`` promotes."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softcap(x, cap: float):
    if cap and cap > 0:
        return torch.tanh(div(x, cap)) * cap
    return x


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, base: float, device="cuda"):
    half = head_dim // 2
    return torch.pow(base, div(-torch.arange(0, half, dtype=torch.float32,
                                             device=device), half))


def _rotate(x, ang):
    """Rotate the (even, odd halves) pairs of x (..., S, H, D) by ang
    (..., S, D/2), in float32; cast back to x's dtype."""
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S) int. Rotates pairs (even, odd
    halves split convention)."""
    freqs = rope_freqs(x.shape[-1], base, x.device)  # (d/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, d/2)
    return _rotate(x, ang)


def apply_mrope(x, positions3, sections: Tuple[int, ...], base: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL): positions3 (3, ..., S) for (t, h, w);
    frequency channels are split into per-section groups, each rotated by its
    own position stream. ``sum(sections) == head_dim // 2``."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, d)
    freqs = rope_freqs(d, base, x.device)  # (half,)
    angs = []
    off = 0
    for i, sec in enumerate(sections):
        # an index past the leading axis reads its last row, as jnp indexing
        # clamps: text-only (B, S) positions reach here unbroadcast from
        # ``attention._rope_qk``, and every row is the same arange
        pos = positions3[min(i, positions3.shape[0] - 1)]  # (..., S)
        angs.append(pos[..., :, None].to(torch.float32) * freqs[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(angs, dim=-1))  # (..., S, half)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Token-level CE in f32 with optional z-loss; returns (loss, aux)."""
    lf = logits.to(torch.float32)
    labels = labels.long()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None])[..., 0]
    ce = lse - ll
    zl = z_loss * torch.square(lse)
    per_tok = ce + zl
    if mask is None:
        mask = torch.ones_like(ce)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(per_tok * mask) / denom
    acc = torch.sum((torch.argmax(lf, -1) == labels) * mask) / denom
    return loss, {"ce": torch.sum(ce * mask) / denom, "accuracy": acc}
