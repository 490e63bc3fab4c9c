"""Pulse-update engine: the Analog Update (paper eq. 2/5) on device arrays.

Two fidelity modes, as in the JAX package's ``core/pulse.py``:
  * ``fused`` (default): one aggregated update with a stochastically
    rounded pulse count plus aggregated c2c noise. Soft-bounds and linear
    devices go through ``kernels.ops.analog_update`` (the CUDA kernel on the
    card); other families through ``_fused_generic``.
  * ``train``: an explicit BL-deep pulse train, each pulse re-evaluating the
    response at the current weight (AIHWKit fidelity; small-scale tests).
"""
from __future__ import annotations

import torch

from .. import prng
from ..kernels import ops as kops
from ..kernels import ref as kref
from .device import DeviceConfig, DeviceParams, fg, responses


def analog_update(w, dw, dp: DeviceParams, cfg: DeviceConfig, key, *,
                  bl: int = 0, mode: str = "fused", rng: str = "threefry",
                  noise=None):
    """Apply the desired increment ``dw`` to analog array ``w`` by pulses.

    ``noise`` optionally carries pre-drawn ``(ubits, zeta)``; the grouped
    engine's fused backend passes one batched stream for a whole stack.
    """
    if cfg.kind in ("softbounds", "linear") and mode == "fused":
        return kops.analog_update(
            w, dw, dp["gamma"], dp["rho"], key,
            dw_min=cfg.dw_min, tau_min=cfg.tau_min, tau_max=cfg.tau_max,
            sigma_c2c=cfg.sigma_c2c, bl=bl, rng=rng, noise=noise)
    if mode == "fused":
        return _fused_generic(w, dw, dp, cfg, key, bl=bl, noise=noise)
    if mode == "train":
        return _pulse_train(w, dw, dp, cfg, key, bl=max(bl, 1))
    raise ValueError(f"unknown pulse mode {mode}")


def _stochastic_round(x, key):
    fl = torch.floor(x)
    u = prng.uniform(key, x.shape, device=x.device)
    return fl + (u < x - fl).to(torch.float32)


def _fused_generic(w, dw, dp, cfg, key, *, bl, noise=None):
    """Fused update for any response family (the kernels' generic oracle).
    With pre-drawn ``noise=(ubits, zeta)`` the rounding uniform is
    ``ubits * 2**-32``, the expression the kernel and ``ref`` use."""
    f32 = torch.float32
    wf = w.to(f32)
    x = kref.div(dw.to(f32), cfg.dw_min)
    if noise is None:
        ku, kz = prng.split(key)
        n_q = _stochastic_round(x, ku)
        zeta = prng.normal(kz, w.shape, w.device)
    else:
        ubits, zeta = noise
        fl = torch.floor(x)
        u = kref.u32_to_f32(ubits) * (1.0 / 4294967296.0)
        n_q = fl + (u < x - fl).to(f32)
    if bl:
        n_q = torch.clamp(n_q, -float(bl), float(bl))
    delta = n_q * cfg.dw_min
    f, g = fg(wf, dp, cfg)
    qp, qm = responses(wf, dp, cfg)
    q_dir = torch.where(delta >= 0, qp, qm)
    amp = cfg.dw_min * cfg.sigma_c2c * torch.sqrt(torch.abs(n_q)) * q_dir
    out = wf + delta * f - torch.abs(delta) * g + amp * zeta
    return torch.clamp(out, -cfg.tau_min, cfg.tau_max).to(w.dtype)


def _pulse_train(w, dw, dp, cfg, key, *, bl):
    """Explicit sequential pulse train (response re-evaluated per pulse)."""
    ku, kz = prng.split(key)
    n_q = _stochastic_round(kref.div(dw.to(torch.float32), cfg.dw_min), ku)
    n_q = torch.clamp(n_q, -float(bl), float(bl))
    sign = torch.sign(n_q)
    n_abs = torch.abs(n_q)
    wf = w.to(torch.float32)
    k = kz
    for i in range(bl):
        k, kn = prng.split(k)
        live = (i < n_abs).to(torch.float32)
        eps = live * sign * cfg.dw_min
        qp, qm = responses(wf, dp, cfg)
        f = (qm + qp) * 0.5
        g = (qm - qp) * 0.5
        c2c = 1.0 + cfg.sigma_c2c * prng.normal(kn, wf.shape, wf.device)
        step = (eps * f - torch.abs(eps) * g) * c2c
        wf = torch.clamp(wf + step, -cfg.tau_min, cfg.tau_max)
    return wf.to(w.dtype)


def zs_step(w, eps, dp: DeviceParams, cfg: DeviceConfig, key=None):
    """One zero-shifting pulse (paper eq. 7): w + eps*F(w) - |eps|*G(w),
    with c2c noise when ``cfg.sigma_c2c > 0`` and a key is given."""
    wf = w.to(torch.float32)
    f, g = fg(wf, dp, cfg)
    step = eps * f - torch.abs(eps) * g
    if cfg.sigma_c2c > 0.0 and key is not None:
        step = step * (1.0 + cfg.sigma_c2c
                       * prng.normal(key, wf.shape, wf.device))
    return torch.clamp(wf + step, -cfg.tau_min, cfg.tau_max).to(w.dtype)
