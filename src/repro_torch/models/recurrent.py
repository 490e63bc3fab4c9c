"""Recurrent sequence mixers: RG-LRU (Griffin / RecurrentGemma) and Mamba-2
SSD.

Port of the JAX package's ``models/recurrent.py``: the RG-LRU runs its
linear recurrence as an associative scan, Mamba-2 as the chunked matmul
SSD algorithm. Serving carries constant-size recurrent states:
``*_forward_with_state`` (prefill; SSD also continues from a previous
chunk's state over a right-padded batch), ``*_decode`` (one token) and
``make_*_state``. The states are returned as new tensors; the caller
writes them into its cache.

``associative_scan`` is ``jax.lax.associative_scan``'s recursion written as
tensor slicing: the pairwise-combined odd/even elements are scanned, then
the evens fixed up, so it does the reference's multiplications in the
reference's order, in O(log S) levels of whole-tensor operations (a loop
over time would issue S launches a layer on the card). XLA-CPU contracts
``a2 * b1 + b2`` into a fused multiply-add inside a fusion, so the two
packages agree within a tolerance, not bit for bit. ``torch.einsum`` may
contract SSD's three-operand einsums in another order than ``jnp.einsum``.

Under ``common.model_parallel`` the training forwards run on this rank's
block of the channels (``distributed.sharding.tp_layout``): the RG-LRU's
whole gate blocks, its recurrence and ``lam`` (each block's recurrence is
its own), SSD's heads with their ``A``, ``dt_bias`` and ``d_skip``, and
``B``/``C`` by group, or whole when the groups do not divide (the weights
read whole, their gradients summed). Both sum ``wout``'s row split over the
model group; SSD's gated norm, over all of ``d_inner``, sums its sum of
squares over the group (``common.rms_norm_over_model``). The serving paths
run whole, as the reference serves under no mesh.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec
from .common import (copy_to_model, dense_init, dot, einsum, model_index,
                     reduce_from_model, rms_norm_over_model, split_width,
                     zeros)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (shared)
# ---------------------------------------------------------------------------


def causal_conv(u, w, state=None, lengths=None):
    """u: (B, S, C); w: (k, C) depthwise causal; state: (B, k-1, C) prior
    inputs (zeros when None). Returns (y, new_state), the state being the
    last k-1 inputs (B, k-1, C). With per-row ``lengths`` (B,) it holds the
    last k-1 inputs of each row's valid run, reaching into the prior state
    for rows shorter than k-1: a right-padded tail never enters it."""
    k = w.shape[0]
    S = u.shape[1]
    if state is None:
        up = F.pad(u, (0, 0, k - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    f32 = torch.float32
    y = 0
    for j in range(k):  # the reference's sum(...), from 0, in j order
        y = y + w[j].to(f32) * up[:, j:j + S].to(f32)
    if k <= 1:
        new_state = None
    elif lengths is None:
        new_state = up[:, -(k - 1):]
    else:
        # valid input t sits at up[:, t + k - 1]; keep t = length-k+1 .. length-1
        idx = (lengths.long()[:, None]
               + torch.arange(k - 1, device=u.device)[None, :])
        new_state = torch.gather(up, 1, idx[:, :, None].expand(-1, -1, up.shape[2]))
    return y.to(u.dtype), new_state


# ---------------------------------------------------------------------------
# associative scan
# ---------------------------------------------------------------------------


def _interleave(even, odd, axis: int):
    """even[0], odd[0], even[1], odd[1], ... along ``axis``; ``even`` has as
    many elements as ``odd`` or one more."""
    n_odd = odd.shape[axis]
    pairs = torch.stack([even.narrow(axis, 0, n_odd), odd], dim=axis + 1)
    shape = list(odd.shape)
    shape[axis] = 2 * n_odd
    out = pairs.reshape(shape)
    if even.shape[axis] > n_odd:
        out = torch.cat([out, even.narrow(axis, n_odd, 1)], dim=axis)
    return out


def associative_scan(fn, elems, axis: int):
    """``jax.lax.associative_scan(fn, elems, axis=axis)`` for a tuple of
    tensors: inclusive scan of the associative ``fn(earlier, later)``."""

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.ndim
        idx[axis] = slice(start, stop, step)
        return e[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                     tuple(sl(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in elems))
        else:
            even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis)
                     for e, r in zip(elems, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(tuple(elems))


def _linear_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


# ---------------------------------------------------------------------------
# RG-LRU (Griffin)
# ---------------------------------------------------------------------------


def _rglru_blocks(cfg: ModelConfig) -> int:
    """Gate matrices are block-diagonal by heads (Griffin)."""
    return max(1, cfg.n_heads)


def _linspace_f32(start: float, stop: float, n: int, device):
    return torch.linspace(start, stop, n, dtype=torch.float32, device=device)


def init_rglru(key, cfg: ModelConfig, device="cuda") -> Dict:
    d, dr = cfg.d_model, cfg.rnn_width
    nb = _rglru_blocks(cfg)
    bk = dr // nb
    ks = prng.split(key, 6)
    if torch.device(device).type == "meta":
        lam0 = torch.empty((dr,), dtype=torch.float32, device="meta")
    else:
        # Lambda init so a = sigma(lam)^(c*r) spreads over [0.9, 0.999]
        lam0 = torch.log(torch.expm1(_linspace_f32(0.001, 0.1, dr, device))
                         + 1e-8)

    def dense(k, shape, fan_in=None):
        return dense_init(k, shape, cfg.dtype, fan_in=fan_in, device=device)

    return {
        "wx": dense(ks[0], (d, dr)),
        "wy": dense(ks[1], (d, dr)),
        "conv": dense(ks[2], (cfg.conv_k, dr), cfg.conv_k),
        "war": dense(ks[3], (nb, bk, bk), bk),
        "wai": dense(ks[4], (nb, bk, bk), bk),
        "lam": lam0,
        "wout": dense(ks[5], (dr, d), dr),
    }


def _block_gate(u, w):
    """u: (B, S, dr) x block-diagonal w: (nb, bk, bk) -> (B, S, dr)."""
    B, S, dr = u.shape
    nb, bk, _ = w.shape
    out = einsum("bsnk,nkj->bsnj", u.reshape(B, S, nb, bk), w)
    return out.reshape(B, S, dr)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rglru_gates(p, u, cfg: ModelConfig):
    f32 = torch.float32
    r = torch.sigmoid(_block_gate(u, p["war"]).to(f32))
    i = torch.sigmoid(_block_gate(u, p["wai"]).to(f32))
    log_a = -cfg.rglru_c * _softplus(p["lam"]) * r     # (B, S, dr) f32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i * u.to(f32))
    return a, b


def _rglru_core(p, x, cfg: ModelConfig):
    """(y, h, conv state) on this rank's channels: all of them, or under
    ``common.model_parallel`` its block of whole gate blocks (``wx``/``wy``
    columns, ``conv``, ``war``/``wai``, ``lam``), ``wout``'s rows summed
    over the model group (where the reference's hint at recurrent.py:115
    puts the model axis back on the residual)."""
    split = split_width(p["wx"].shape[-1], cfg.rnn_width, "mix/wx")
    xin = copy_to_model(x) if split else x
    gate = F.gelu(dot(xin, p["wy"]).to(torch.float32), approximate="tanh")
    u, conv_state = causal_conv(dot(xin, p["wx"]), p["conv"])
    a, b = _rglru_gates(p, u, cfg)
    _, h = associative_scan(_linear_combine, (a, b), axis=1)
    y = dot((gate * h).to(x.dtype), p["wout"])
    return (reduce_from_model(y) if split else y), h, conv_state


def rglru_forward(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d). Parallel scan over time."""
    y, _, _ = _rglru_core(p, x, cfg)
    return y


def rglru_forward_with_state(p, x, cfg: ModelConfig):
    """Prefill: the full forward and the final recurrent and conv state."""
    y, h, conv_state = _rglru_core(p, x, cfg)
    return y, {"h": h[:, -1], "conv": conv_state}


def rglru_decode(p, x, state: Dict, cfg: ModelConfig):
    """x: (B, 1, d); state: {'h': (B, dr) f32, 'conv': (B, k-1, dr)}."""
    gate = F.gelu(dot(x, p["wy"]).to(torch.float32), approximate="tanh")
    u, conv_state = causal_conv(dot(x, p["wx"]), p["conv"], state["conv"])
    a, b = _rglru_gates(p, u, cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = dot((gate[:, 0] * h)[:, None].to(x.dtype), p["wout"])
    return y, {"h": h, "conv": conv_state}


def _state_leaves(shapes, abstract: bool, device):
    """A nested dict of ((shape), dtype) leaves as zeros or ``TensorSpec``s."""
    if isinstance(shapes, dict):
        return {n: _state_leaves(v, abstract, device) for n, v in shapes.items()}
    shape, dt = shapes
    if abstract:
        return TensorSpec(shape, dt, device)
    return torch.zeros(shape, dtype=dt, device=device)


def make_rglru_state(cfg: ModelConfig, batch: int, abstract=False,
                     device="cuda"):
    dr = cfg.rnn_width
    return _state_leaves({"h": ((batch, dr), torch.float32),
                          "conv": ((batch, cfg.conv_k - 1, dr), cfg.dtype)},
                         abstract, device)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD: state space duality, chunked matmul form)
# ---------------------------------------------------------------------------


def init_ssm(key, cfg: ModelConfig, device="cuda") -> Dict:
    """Input projection split into per-stream matrices (z/x/B/C/dt)."""
    d = cfg.d_model
    din = cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.d_state, cfg.ssm_groups
    ks = prng.split(key, 7)
    f32 = torch.float32

    def dense(k, shape, fan_in=None):
        return dense_init(k, shape, cfg.dtype, fan_in=fan_in, device=device)

    if torch.device(device).type == "meta":
        a_log = torch.empty((H,), dtype=f32, device="meta")
    else:
        a_log = torch.log(_linspace_f32(1.0, 16.0, H, device))
    return {
        "wz": dense(ks[0], (d, din)),
        "wx": dense(ks[1], (d, din)),
        "wb": dense(ks[2], (d, G * N)),
        "wc": dense(ks[3], (d, G * N)),
        "wdt": dense(ks[4], (d, H)),
        "conv_x": dense(ks[5], (cfg.d_conv, din), cfg.d_conv),
        "conv_b": dense(prng.fold_in(ks[5], 1), (cfg.d_conv, G * N), cfg.d_conv),
        "conv_c": dense(prng.fold_in(ks[5], 2), (cfg.d_conv, G * N), cfg.d_conv),
        "a_log": a_log,
        "dt_bias": zeros((H,), f32, device),
        "d_skip": torch.ones((H,), dtype=f32, device=device),
        "norm": zeros((din,), cfg.dtype, device),
        "wout": dense(ks[6], (din, d), din),
    }


def _segsum(x):
    """x: (..., L) -> (..., L, L) lower-triangular cumulative segment sums,
    -inf above the diagonal."""
    L = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    d = xc[..., :, None] - xc[..., None, :]
    idx = torch.arange(L, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, d, torch.full((), -torch.inf, dtype=d.dtype,
                                           device=d.device))


def ssd_chunked(x, dt_a, B, C, chunk: int, init_state=None):
    """Chunked SSD (Mamba-2 alg. 3). x: (b, s, h, p) pre-multiplied by dt;
    dt_a: (b, s, h) = A*dt (<= 0); B, C: (b, s, h, n). Returns
    ((b, s, h, p), the final state (b, h, p, n) f32).

    ``init_state`` (b, h, p, n) seeds the inter-chunk recurrence. A tail
    short of a whole chunk is zero-padded, which is exact: the decay over
    the padding is exp(0) = 1 and it adds no state."""
    b, s_orig, h, p_dim = x.shape
    n = B.shape[-1]
    L = min(chunk, s_orig)
    pad = (-s_orig) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_a = F.pad(dt_a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s = s_orig + pad
    c = s // L
    f32 = torch.float32

    def ch(t):
        return t.to(f32).reshape(b, c, L, *t.shape[2:])

    xc, dac, Bc, Cc = ch(x), ch(dt_a), ch(B), ch(C)

    a_cum = torch.cumsum(dac, dim=2)                                # (b,c,L,h)
    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dac.transpose(2, 3)))                  # (b,c,h,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)             # (b,c,h,L,S)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xc)

    # per-chunk final states
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)           # (b,c,L,h)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          Bc * decay_states[..., None], xc)

    # inter-chunk recurrence (the reference's lax.scan over chunks)
    chunk_decay = torch.exp(a_cum[:, :, -1])                        # (b,c,h)
    prev = (torch.zeros((b, h, p_dim, n), dtype=f32, device=x.device)
            if init_state is None else init_state.to(f32))
    prevs = []
    for ci in range(c):
        prevs.append(prev)
        prev = chunk_decay[:, ci, :, None, None] * prev + states[:, ci]
    prev_states = torch.stack(prevs, dim=1)                         # (b,c,h,p,n)

    state_decay = torch.exp(a_cum)                                  # (b,c,L,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc * state_decay[..., None],
                         prev_states)
    y = (y_diag + y_off).reshape(b, s, h, p_dim)[:, :s_orig]
    return y, prev


def _ssm_split(p, x, cfg: ModelConfig, conv_state=None, lengths=None):
    """(z, xs, B, C, dt, conv state) on this rank's heads: all of them, or
    under ``common.model_parallel`` its block (``wz``/``wx``/``wdt``
    columns, ``conv_x``, ``dt_bias``), ``B``/``C`` of its groups when
    ``tp_layout`` split ``wb``/``wc``, else read whole (their weights
    through ``copy_to_model``: each rank's heads give part of their
    gradient) and cut to its heads' groups."""
    N, G = cfg.d_state, cfg.ssm_groups
    H = p["wdt"].shape[-1]                     # this rank's heads
    split = split_width(H, cfg.ssm_heads, "mix/wdt")
    bc = {n: p[n] for n in ("wb", "wc", "conv_b", "conv_c")}
    first = 0
    if split:
        x = copy_to_model(x)
        if not split_width(p["wb"].shape[-1], G * N, "mix/wb"):
            bc = {n: copy_to_model(w) for n, w in bc.items()}
            first = model_index() * H
    cs = conv_state or {}
    z = dot(x, p["wz"])
    xs, ncx = causal_conv(dot(x, p["wx"]), p["conv_x"], cs.get("x"), lengths)
    B_, ncb = causal_conv(dot(x, bc["wb"]), bc["conv_b"], cs.get("b"), lengths)
    C_, ncc = causal_conv(dot(x, bc["wc"]), bc["conv_c"], cs.get("c"), lengths)
    new_conv = {"x": ncx, "b": ncb, "c": ncc}
    dt = dot(x, p["wdt"])                                           # (B,S,H)
    xs, B_, C_ = F.silu(xs), F.silu(B_), F.silu(C_)
    Bsz, S = x.shape[0], x.shape[1]
    xs = xs.reshape(Bsz, S, H, cfg.ssm_head_dim)
    # jnp.repeat over heads as expand: its backward is a reduction, in a
    # fixed order (repeat_interleave's adds with atomics on CUDA); head h
    # reads group h // (ssm_heads / G)
    rep = cfg.ssm_heads // G
    Gl = B_.shape[-1] // N                     # the groups read here

    def per_head(t):
        t = t.reshape(Bsz, S, Gl, 1, N).expand(Bsz, S, Gl, rep, N).reshape(
            Bsz, S, Gl * rep, N)
        return t if Gl * rep == H else t.narrow(2, first, H)

    B_, C_ = per_head(B_), per_head(C_)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    if lengths is not None:
        # a zero dt past a row's valid run makes its padding exact for SSD:
        # x*dt adds nothing and the decay exp(dt*A) = 1 carries the state
        valid = (torch.arange(S, device=x.device)[None, :]
                 < lengths.long()[:, None])
        dt = torch.where(valid[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                           device=dt.device))
    return z, xs, B_, C_, dt, new_conv


def _ssm_out(p, y, z, x, cfg: ModelConfig):
    """The gated norm over all of ``d_inner`` and ``wout``: on this rank's
    channels under ``common.model_parallel``, ``wout``'s rows summed over
    the model group (the reference's hint at recurrent.py:300)."""
    y = y * F.silu(z.to(torch.float32))
    y = rms_norm_over_model(y.to(x.dtype), p["norm"], cfg.norm_eps)
    out = dot(y, p["wout"])
    if split_width(p["wout"].shape[0], cfg.d_inner, "mix/wout"):
        return reduce_from_model(out)
    return out


def _ssm_core(p, x, cfg: ModelConfig, state=None, lengths=None):
    conv_state = state["conv"] if state is not None else None
    init_h = state["h"] if state is not None else None
    z, xs, B_, C_, dt, new_conv = _ssm_split(p, x, cfg, conv_state, lengths)
    A = -torch.exp(p["a_log"])                                      # (H,)
    f32 = torch.float32
    y, final = ssd_chunked(xs.to(f32) * dt[..., None], dt * A, B_, C_,
                           cfg.ssm_chunk, init_state=init_h)
    y = y + p["d_skip"][None, None, :, None] * xs.to(f32)
    y = y.reshape(*x.shape[:2], -1)
    return _ssm_out(p, y, z, x, cfg), final, new_conv


def ssm_forward(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d). Chunked SSD training path."""
    out, _, _ = _ssm_core(p, x, cfg)
    return out


def ssm_forward_with_state(p, x, cfg: ModelConfig, state=None, lengths=None):
    """Prefill: the full forward and the final {'h', 'conv'} state.
    ``state`` seeds a chunk continuation (the previous chunk's state);
    ``lengths`` (B,) marks each row's valid run in a right-padded batch
    (dt is zero past it)."""
    out, final, new_conv = _ssm_core(p, x, cfg, state, lengths)
    return out, {"h": final, "conv": new_conv}


def ssm_decode(p, x, state: Dict, cfg: ModelConfig):
    """x: (B, 1, d); state: {'h': (B, H, P, N) f32, 'conv': {'x', 'b',
    'c': (B, k-1, ...)}}."""
    z, xs, B_, C_, dt, new_conv = _ssm_split(p, x, cfg, state["conv"])
    f32 = torch.float32
    A = -torch.exp(p["a_log"])
    dA = torch.exp(dt[:, 0] * A)                                    # (B,H)
    xdt = xs[:, 0].to(f32) * dt[:, 0][..., None]                    # (B,H,P)
    h = dA[..., None, None] * state["h"] + torch.einsum(
        "bhp,bhn->bhpn", xdt, B_[:, 0].to(f32))
    y = torch.einsum("bhpn,bhn->bhp", h, C_[:, 0].to(f32))
    y = y + p["d_skip"][None, :, None] * xs[:, 0].to(f32)
    y = y.reshape(x.shape[0], 1, cfg.d_inner)
    return _ssm_out(p, y, z[:, :1], x, cfg), {"h": h, "conv": new_conv}


def make_ssm_state(cfg: ModelConfig, batch: int, abstract=False,
                   device="cuda"):
    H, N, G = cfg.ssm_heads, cfg.d_state, cfg.ssm_groups
    km1 = cfg.d_conv - 1
    return _state_leaves({
        "h": ((batch, H, cfg.ssm_head_dim, N), torch.float32),
        "conv": {"x": ((batch, km1, cfg.d_inner), cfg.dtype),
                 "b": ((batch, km1, G * N), cfg.dtype),
                 "c": ((batch, km1, G * N), cfg.dtype)}}, abstract, device)
