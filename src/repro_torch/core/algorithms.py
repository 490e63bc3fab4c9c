"""The seven analog training algorithms over a unified tile interface.

Port of the JAX package's ``core/algorithms.py``. Every algorithm has

  begin_step(state, key, cfg)        -> state'   (chopper draw, E-RIDER Q~ sync)
  effective_weight(state, cfg)       -> model weight seen by forward/backward
  update(state, grad, key, cfg, lr)  -> (state', metrics)

plus ``update_batched``, the same update over a whole ``(n, *member)`` stack
in one program (the grouped engine's 'fused' backend: one 3-D kernel launch
per array). ``inplace=True`` (the donated train step) writes every changed
leaf into its own storage (the pulse updates through K1's in-place mode,
the rest through ``out=`` or in-place ops) and returns a state on the
given tensors, bit-equal to the state returned without it. Algorithms: sgd, ttv1, ttv2, agad, residual, rider (Alg. 2),
erider (Alg. 3); see the JAX module for the paper references.

Keys live on the host (``prng``), so the chopper draw is a host boolean and
``begin_step`` launches nothing on the card. Mean reductions sum in another
order than XLA's, so metrics and the absmean gradient norm agree with the
JAX package to float32 ULPs, not bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import prng
from ..kernels import fastrng
from ..kernels import ref as kref
from .device import fg, sample_device, symmetric_point
from .pulse import analog_update
from .tile import TileConfig, TileState, expected_pulses

Metrics = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _au(x, dx, dev, dcfg, key, cfg: TileConfig, inplace: bool = False):
    return analog_update(x, dx, dev, dcfg, key, bl=cfg.bl, mode=cfg.pulse_mode,
                         rng=cfg.rng, out=x if inplace else None)


def _dev(st: TileState, which: str, cfg: TileConfig, shape):
    """Device params, regenerated from the tile seed when not stored."""
    dev = st.get(f"dev_{which}")
    if dev is not None:
        return dev
    key = prng.wrap_key_data(st[f"seed_{which}"])
    dcfg = cfg.device_p if which == "p" else cfg.device_w
    return sample_device(key, shape, dcfg, method=cfg.rng,
                         device=st["W"].device)


def _has_dev_p(st: TileState) -> bool:
    return st.get("dev_p") is not None or st.get("seed_p") is not None


def _base_metrics(cfg: TileConfig, st: TileState, dw_p=None, dw_w=None,
                  dev_p=None) -> Metrics:
    """Pulses, and under ``metrics="full"`` P's |G|^2 and SP error at
    ``dev_p``, the update's own draw of P's device (drawn here if None)."""
    if cfg.metrics == "none":
        return {}
    m: Metrics = {}
    pulses = torch.zeros((), dtype=torch.float32, device=st["W"].device)
    if dw_p is not None:
        pulses = pulses + expected_pulses(dw_p, cfg.device_p.dw_min, cfg.bl)
    if dw_w is not None:
        pulses = pulses + expected_pulses(dw_w, cfg.device_w.dw_min, cfg.bl)
    m["pulses"] = pulses
    if cfg.metrics == "pulses":
        return m
    if st.get("P") is not None and _has_dev_p(st):
        if dev_p is None:
            dev_p = _dev(st, "p", cfg, st["P"].shape)
        _, g = fg(st["P"].to(torch.float32), dev_p, cfg.device_p)
        m["gp_sq"] = torch.mean(g * g)
        if st.get("Qd") is not None:
            sp = symmetric_point(dev_p, cfg.device_p)
            m["sp_err"] = torch.mean((st["Qd"].to(torch.float32) - sp) ** 2)
    return m


def _grad_to_analog(st: TileState, grad, cfg: TileConfig):
    """Model-space gradient -> analog-space gradient (chain through scale);
    'absmean' rescales by the tile's mean |g| so lr_p counts pulses."""
    g = grad.to(torch.float32) * st["scale"]
    if cfg.grad_norm == "absmean":
        g = g / (torch.mean(torch.abs(g)) + 1e-12) * cfg.device_p.dw_min
    return g


def _bc(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-tile scalars (n,) -> (n, 1, ..., 1) for an ndim-D stack."""
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.ndim))


def _ema(q, p_new, eta: float, inplace: bool = False):
    """(12): (1 - eta) q + eta p_new in float32, rounded once to q's dtype
    (in place: at the store into q, as ``.to`` rounds; no fused lerp or
    multiply-add, which would round otherwise)."""
    mixed = (1.0 - eta) * q.to(torch.float32)
    if inplace:
        return torch.add(mixed, eta * p_new, out=q)
    return (mixed + eta * p_new).to(q.dtype)


def _drain(h, dw, st: TileState, inplace: bool):
    """The transfer buffer less what was transferred: ``h - dw``, written
    into ``st["H"]`` in place."""
    return torch.sub(h, dw, out=st["H"] if inplace else None)


def _tick(t, inplace: bool, n=1):
    return t.add_(n) if inplace else t + n


# ---------------------------------------------------------------------------
# begin_step
# ---------------------------------------------------------------------------


def begin_step(st: TileState, key, cfg: TileConfig,
               inplace: bool = False) -> TileState:
    """Pre-forward phase: draw chopper c_k (17); E-RIDER reprograms Q~ from
    the digital Q on a flip (Alg. 3 lines 4-6). In place, Q~ takes Q's
    values by a copy: the two leaves must stay two buffers, as the later
    in-place EMA writes Q alone."""
    if cfg.algorithm not in ("agad", "erider"):
        return st
    st = TileState(st)
    flip = bool(prng.bernoulli(key, cfg.chopper_p))
    if flip:
        st["c"] = st["c"].neg_() if inplace else -st["c"]
        if cfg.algorithm == "erider":
            st["Qt"] = st["Qt"].copy_(st["Qd"]) if inplace else st["Qd"]
    if cfg.algorithm == "erider":
        st["prog"] = _tick(st["prog"], inplace, int(flip))
    return st


# ---------------------------------------------------------------------------
# effective weight (model space)
# ---------------------------------------------------------------------------


def effective_weight(st: TileState, cfg: TileConfig):
    """Model-space weight in the tile's storage dtype. Works on one tile or
    on a stack whose per-tile scalars lead the array axes."""
    a = cfg.algorithm
    w = st["W"].to(torch.float32)
    nd = w.ndim

    def sc(name):
        return _bc(st[name], nd)

    if a == "sgd":
        eff = w
    elif a in ("ttv1", "ttv2"):
        eff = w + cfg.gamma * st["P"].to(torch.float32)
    elif a == "agad":
        eff = w  # gradients on the main array only (App. B.2)
    elif a in ("residual", "rider"):
        eff = w + cfg.gamma * (st["P"] - st["Qd"]).to(torch.float32)
    elif a == "erider":
        eff = w + cfg.gamma * sc("c") * (st["P"] - st["Qt"]).to(torch.float32)
    else:
        raise ValueError(a)
    return (eff * sc("scale")).to(st["W"].dtype)


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def update(st: TileState, grad, key, cfg: TileConfig, lr,
           inplace: bool = False) -> Tuple[TileState, Metrics]:
    a = cfg.algorithm
    st = TileState(st)
    dev = st["W"].device
    g = _grad_to_analog(st, grad, cfg)
    kp, kw, _ = prng.split(key, 3)
    alpha = lr * cfg.lr_p
    beta = lr * cfg.lr_w
    shape = st["W"].shape
    dev_w = _dev(st, "w", cfg, shape)
    dev_p = _dev(st, "p", cfg, shape) if _has_dev_p(st) else None

    if a == "sgd":
        dw = -beta * g
        st["W"] = _au(st["W"], dw, dev_w, cfg.device_w, kw, cfg, inplace)
        metrics = _base_metrics(cfg, st, dw_w=dw)

    elif a in ("ttv1", "ttv2", "agad"):
        c = st["c"] if a == "agad" else torch.ones((), device=dev)
        dp = -alpha * c * g
        st["P"] = _au(st["P"], dp, dev_p, cfg.device_p, kp, cfg, inplace)
        do_transfer = (st["t"] % cfg.transfer_every) == 0
        read = st["P"].to(torch.float32)  # analog readout of the fast array
        if a == "ttv1":
            dw = torch.where(do_transfer, beta * read, 0.0)
            st["W"] = _au(st["W"], dw, dev_w, cfg.device_w, kw, cfg,
                          inplace)
        else:
            if a == "agad":
                # dynamic reference: low-pass of the readout (Rasch et al.)
                st["Qd"] = _ema(st["Qd"], read, cfg.eta, inplace)
                read = read - st["Qd"].to(torch.float32)
            thr = cfg.threshold * cfg.device_w.dw_min
            h = st["H"] + torch.where(do_transfer, beta * c * read, 0.0)
            dw = torch.trunc(kref.div(h, thr)) * thr
            st["H"] = _drain(h, dw, st, inplace)
            st["W"] = _au(st["W"], dw, dev_w, cfg.device_w, kw, cfg,
                          inplace)
        metrics = _base_metrics(cfg, st, dw_p=dp, dw_w=dw, dev_p=dev_p)

    elif a in ("residual", "rider", "erider"):
        c = st["c"] if a == "erider" else torch.ones((), device=dev)
        # (11a)/(18a): P <- P - alpha c grad
        dp = -alpha * c * g
        st["P"] = _au(st["P"], dp, dev_p, cfg.device_p, kp, cfg, inplace)
        p_new = st["P"].to(torch.float32)
        # (11b)/(18b): W <- W + beta c (P_{k+1} - Q_k)
        q_ref = st["Qt"] if a == "erider" else st["Qd"]
        dw = beta * c * (p_new - q_ref.to(torch.float32))
        if cfg.buffered_transfer:
            thr = cfg.threshold * cfg.device_w.dw_min
            h = st["H"] + dw
            dw = torch.trunc(kref.div(h, thr)) * thr
            st["H"] = _drain(h, dw, st, inplace)
        st["W"] = _au(st["W"], dw, dev_w, cfg.device_w, kw, cfg, inplace)
        # (12): digital EMA tracking (rider/erider only)
        if a in ("rider", "erider"):
            st["Qd"] = _ema(st["Qd"], p_new, cfg.eta, inplace)
        metrics = _base_metrics(cfg, st, dw_p=dp, dw_w=dw, dev_p=dev_p)
        if a == "erider" and cfg.metrics != "none":
            metrics["prog_events"] = st["prog"].to(torch.float32)

    else:
        raise ValueError(a)

    st["t"] = _tick(st["t"], inplace)
    return st, metrics


# ---------------------------------------------------------------------------
# batched update (the grouped engine's 'fused' backend)
# ---------------------------------------------------------------------------


def _hash_noise_batched(seeds, shape, device):
    """Per-tile fastrng streams for an (n, *shape) stack: row i is exactly
    what ``ops.analog_update(rng='hash')`` draws for tile i alone (the
    noise operands of the pulse modes K1 does not run)."""
    return (fastrng.hash_bits(seeds, shape, 1, device),
            fastrng.hash_normal(seeds, shape, 2, device))


def update_batched(st: TileState, grad, keys_raw, cfg: TileConfig,
                   lr, inplace: bool = False) -> Tuple[TileState, Metrics]:
    """``update`` over a whole (n, *member) stack in one program: noise from
    per-tile hash streams, one pulse-update launch per array over the whole
    stack (K1's hash-noise mode draws each member's noise in the kernel).
    Bit-identical to the per-member loop with rng='hash': same key
    derivation, same bits, same element-wise math. Per-tile reductions run
    over member axes only."""
    a = cfg.algorithm
    st = TileState(st)
    nd = st["W"].ndim
    axes = tuple(range(1, nd))
    member = tuple(st["W"].shape[1:])
    device = st["W"].device

    def bc(x):
        return _bc(x, nd)

    def dev_of(which):
        dev = st.get(f"dev_{which}")
        if dev is not None:
            return dev
        dcfg = cfg.device_p if which == "p" else cfg.device_w
        return sample_device(st[f"seed_{which}"], member, dcfg,
                             method="hash", device=device)

    def au(x, dx, dev, dcfg, kraw):
        if dcfg.kind in ("softbounds", "linear") and cfg.pulse_mode == "fused":
            key, noise = kraw, None   # K1 draws it, member by member
        else:
            key, noise = None, _hash_noise_batched(kraw, member, device)
        return analog_update(x, dx, dev, dcfg, key, bl=cfg.bl,
                             mode=cfg.pulse_mode, rng="hash", noise=noise,
                             out=x if inplace else None)

    def pulses_of(dw, dw_min):
        n = kref.div(torch.abs(dw.to(torch.float32)), dw_min)
        if cfg.bl:
            n = torch.clamp_max(n, float(cfg.bl))
        return torch.sum(n, dim=axes)

    def base_metrics(dw_p=None, dw_w=None) -> Metrics:
        if cfg.metrics == "none":
            return {}
        m: Metrics = {}
        pulses = torch.zeros(st["scale"].shape, dtype=torch.float32,
                             device=device)
        if dw_p is not None:
            pulses = pulses + pulses_of(dw_p, cfg.device_p.dw_min)
        if dw_w is not None:
            pulses = pulses + pulses_of(dw_w, cfg.device_w.dw_min)
        m["pulses"] = pulses
        if cfg.metrics == "pulses":
            return m
        if st.get("P") is not None and _has_dev_p(st):
            _, gg = fg(st["P"].to(torch.float32), dev_p, cfg.device_p)
            m["gp_sq"] = torch.mean(gg * gg, dim=axes)
            if st.get("Qd") is not None:
                sp = symmetric_point(dev_p, cfg.device_p)
                m["sp_err"] = torch.mean(
                    (st["Qd"].to(torch.float32) - sp) ** 2, dim=axes)
        return m

    g = grad.to(torch.float32) * bc(st["scale"])
    if cfg.grad_norm == "absmean":
        g = (g / (torch.mean(torch.abs(g), dim=axes, keepdim=True) + 1e-12)
             * cfg.device_p.dw_min)
    # per-tile kp/kw key chain, identical to update()'s split(key, 3)
    ks = prng.split(keys_raw, 3)
    kp, kw = ks[:, 0], ks[:, 1]
    alpha = lr * cfg.lr_p
    beta = lr * cfg.lr_w
    dev_w = dev_of("w")
    dev_p = dev_of("p") if _has_dev_p(st) else None
    one = torch.ones((), device=device)

    if a == "sgd":
        dw = -beta * g
        st["W"] = au(st["W"], dw, dev_w, cfg.device_w, kw)
        metrics = base_metrics(dw_w=dw)

    elif a in ("ttv1", "ttv2", "agad"):
        c = bc(st["c"]) if a == "agad" else one
        dp = -alpha * c * g
        st["P"] = au(st["P"], dp, dev_p, cfg.device_p, kp)
        do_transfer = bc((st["t"] % cfg.transfer_every) == 0)
        read = st["P"].to(torch.float32)
        if a == "ttv1":
            dw = torch.where(do_transfer, beta * read, 0.0)
            st["W"] = au(st["W"], dw, dev_w, cfg.device_w, kw)
        else:
            if a == "agad":
                st["Qd"] = _ema(st["Qd"], read, cfg.eta, inplace)
                read = read - st["Qd"].to(torch.float32)
            thr = cfg.threshold * cfg.device_w.dw_min
            h = st["H"] + torch.where(do_transfer, beta * c * read, 0.0)
            dw = torch.trunc(kref.div(h, thr)) * thr
            st["H"] = _drain(h, dw, st, inplace)
            st["W"] = au(st["W"], dw, dev_w, cfg.device_w, kw)
        metrics = base_metrics(dw_p=dp, dw_w=dw)

    elif a in ("residual", "rider", "erider"):
        c = bc(st["c"]) if a == "erider" else one
        dp = -alpha * c * g
        st["P"] = au(st["P"], dp, dev_p, cfg.device_p, kp)
        p_new = st["P"].to(torch.float32)
        q_ref = st["Qt"] if a == "erider" else st["Qd"]
        dw = beta * c * (p_new - q_ref.to(torch.float32))
        if cfg.buffered_transfer:
            thr = cfg.threshold * cfg.device_w.dw_min
            h = st["H"] + dw
            dw = torch.trunc(kref.div(h, thr)) * thr
            st["H"] = _drain(h, dw, st, inplace)
        st["W"] = au(st["W"], dw, dev_w, cfg.device_w, kw)
        if a in ("rider", "erider"):
            st["Qd"] = _ema(st["Qd"], p_new, cfg.eta, inplace)
        metrics = base_metrics(dw_p=dp, dw_w=dw)
        if a == "erider" and cfg.metrics != "none":
            metrics["prog_events"] = st["prog"].to(torch.float32)

    else:
        raise ValueError(a)

    st["t"] = _tick(st["t"], inplace)
    return st, metrics
