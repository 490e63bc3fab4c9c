"""Plain PyTorch versions of the analog math, ported from the JAX package's
``kernels/ref.py``.

They are the single source of truth for the arithmetic: the CPU path runs
them, and on the card the hand-written kernels are held to them bit for bit
in float32. Every scalar division goes through ``div``: torch's CUDA
``tensor / python_float`` multiplies by the reciprocal, which rounds
differently from the true division the kernels (and XLA) do.

Math reference (paper eq. numbers):

  q+(w) = (gamma + rho) * (1 - w / tau_max)          (SoftBoundsReference)
  q-(w) = (gamma - rho) * (1 + w / tau_min)
  F(w)  = (q-(w) + q+(w)) / 2                        (6a)
  G(w)  = (q-(w) - q+(w)) / 2                        (6b)
  w'    = w + delta * F(w) - |delta| * G(w) + noise   (2), with
  delta = dw_min * stochastic_round(dw / dw_min), optionally capped at +-bl.
"""
from __future__ import annotations

import torch

from ..prng import MASK


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division in ``x``'s dtype on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def u32_to_f32(ubits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 in [0, 2**32), or an int32 bit pattern) ->
    float32, rounded to nearest."""
    if ubits.dtype == torch.int32:
        ubits = ubits.to(torch.int64) & MASK
    return ubits.to(torch.float32)


# ---------------------------------------------------------------------------
# response functions
# ---------------------------------------------------------------------------


def q_plus(w, gamma, rho, tau_max):
    return (gamma + rho) * (1.0 - div(w, tau_max))


def q_minus(w, gamma, rho, tau_min):
    return (gamma - rho) * (1.0 + div(w, tau_min))


def response_fg(w, gamma, rho, tau_min, tau_max):
    """(F, G) of eq. (6) for the soft-bounds reference device."""
    qp = q_plus(w, gamma, rho, tau_max)
    qm = q_minus(w, gamma, rho, tau_min)
    return (qm + qp) * 0.5, (qm - qp) * 0.5


# ---------------------------------------------------------------------------
# fused analog pulse update (kernel: csrc/analog_update.cu)
# ---------------------------------------------------------------------------


def analog_update_ref(w, dw, gamma, rho, ubits, zeta, *, dw_min: float,
                      tau_min: float, tau_max: float, sigma_c2c: float,
                      bl: int = 0):
    """The Analog Update (2) with stochastic pulse rounding, element-wise.

    ``ubits`` are uint32 bits for the rounding Bernoulli, ``zeta`` standard
    normals for the aggregated cycle-to-cycle noise. Returns ``w``'s dtype.
    """
    f32 = torch.float32
    wf, dwf = w.to(f32), dw.to(f32)
    gam, rh = gamma.to(f32), rho.to(f32)

    n_real = div(dwf, dw_min)
    n_floor = torch.floor(n_real)
    frac = n_real - n_floor
    u = u32_to_f32(ubits) * (1.0 / 4294967296.0)
    n_q = n_floor + (u < frac).to(f32)
    if bl and bl > 0:
        n_q = torch.clamp(n_q, -float(bl), float(bl))
    delta = n_q * dw_min

    f, g = response_fg(wf, gam, rh, tau_min, tau_max)
    upd = delta * f - torch.abs(delta) * g

    q_dir = torch.where(delta >= 0.0, q_plus(wf, gam, rh, tau_max),
                        q_minus(wf, gam, rh, tau_min))
    noise = (dw_min * sigma_c2c * torch.sqrt(torch.abs(n_q)) * q_dir
             * zeta.to(f32))

    w_new = torch.clamp(wf + upd + noise, -tau_min, tau_max)
    return w_new.to(w.dtype)


def analog_update_expected_ref(w, dw, gamma, rho, *, tau_min, tau_max):
    """Noise-free expectation of the Analog Update (theory tests)."""
    f32 = torch.float32
    wf = w.to(f32)
    f, g = response_fg(wf, gamma.to(f32), rho.to(f32), tau_min, tau_max)
    out = wf + dw.to(f32) * f - torch.abs(dw).to(f32) * g
    return torch.clamp(out, -tau_min, tau_max).to(w.dtype)
