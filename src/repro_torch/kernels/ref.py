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


# ---------------------------------------------------------------------------
# IO-quantized analog MVM (kernel: csrc/analog_mvm.cu)
# ---------------------------------------------------------------------------


def abs_max_scale(x2: torch.Tensor) -> torch.Tensor:
    """ABS_MAX noise management: the (M, 1) float32 row scale of (M, K)
    activations, floored at 1e-12."""
    return torch.clamp_min(
        torch.amax(torch.abs(x2.to(torch.float32)), dim=-1, keepdim=True),
        1e-12)


def _codes(x, s, inp_res: float, inp_bound: float):
    xq = torch.clamp(x / s, -inp_bound, inp_bound)
    return torch.round(xq * (1.0 / inp_res))


def quantize_input(x, s, inp_res: float, inp_bound: float):
    """Input DAC: ``x / s`` (a true division by the row scale) clipped to
    ``+-inp_bound`` and rounded (half to even) to multiples of ``inp_res``.
    The step multiplies by the Python reciprocal, as the reference does."""
    return _codes(x, s, inp_res, inp_bound) * inp_res


def dac_codes(x2: torch.Tensor, inp_res: float, inp_bound: float):
    """The input DAC of (M, K) activations as integers: ``(codes, s)``, the
    float32 codes ``quantize_input(x2, s, ...) / inp_res`` before their
    scaling (so ``codes * inp_res`` is ``quantize_input`` bit for bit) and
    the (M, 1) ABS_MAX row scale. The CUDA prologue writes the same codes
    as bfloat16, which holds them exactly while |code| <= 256."""
    s = abs_max_scale(x2)
    return _codes(x2.to(torch.float32), s, inp_res, inp_bound), s


def split_bf16(w: torch.Tensor):
    """float32 ``w`` as three bfloat16 pieces ``(hi, mid, lo)``: ``hi`` is
    ``w`` cut to bfloat16 toward zero (so it never overflows to inf), then
    ``mid`` and ``lo`` the nearest bfloat16 to what the pieces before them
    leave over. Their sum is ``w`` exactly for |w| >= 2**-110 (24 bits in
    three 8-bit pieces), and within 2**-134 below, where bfloat16's
    subnormal step 2**-133 is coarser than the lowest bits of ``w``. The
    CUDA kernel multiplies the DAC codes by each piece on the tensor
    cores."""
    bf, f32 = torch.bfloat16, torch.float32
    w = w.to(f32).contiguous()
    hi = (w.view(torch.int32) & -65536).view(f32)  # exact in bf16
    r1 = w - hi
    mid = r1.to(bf)
    return hi.to(bf), mid, (r1 - mid.to(f32)).to(bf)


def analog_mvm_ref(x, w, noise, *, inp_res: float, inp_bound: float,
                   out_res: float, out_bound: float, out_noise: float):
    """Analog crossbar MVM with DAC/ADC quantization (paper Table 7):
    ABS_MAX scaling -> input DAC -> matmul -> additive output noise -> ADC
    clip and quantization -> rescale. ``x`` (..., K), ``w`` (K, N),
    ``noise`` standard normals at the output shape. Returns ``x``'s dtype."""
    f32 = torch.float32
    xf, wf = x.to(f32), w.to(f32)
    s = abs_max_scale(xf)
    y = quantize_input(xf, s, inp_res, inp_bound) @ wf
    y = y + out_noise * noise.to(f32)
    y = torch.clamp(y, -out_bound, out_bound)
    y = torch.round(y * (1.0 / out_res)) * out_res
    return (y * s).to(x.dtype)


# ---------------------------------------------------------------------------
# chopped-EMA SP filter (kernel: csrc/sp_filter.cu)
# ---------------------------------------------------------------------------


def sp_filter_terms(q, p, gamma_p, rho_p, *, eta: float, tau_min: float,
                    tau_max: float):
    """The element-wise part of ``sp_filter_ref``, all float32:
    ``(q_new, G_p(p)^2, (q_new - w_sp)^2)`` before any rounding to ``q``'s
    dtype and before the sums."""
    f32 = torch.float32
    qf, pf = q.to(f32), p.to(f32)
    gam, rh = gamma_p.to(f32), rho_p.to(f32)
    q_new = (1.0 - eta) * qf + eta * pf
    _, g = response_fg(pf, gam, rh, tau_min, tau_max)
    a_p = gam + rh
    a_m = gam - rh
    w_sp = (a_p - a_m) / (div(a_p, tau_max) + div(a_m, tau_min))
    d = q_new - w_sp
    return q_new, g * g, d * d


def sp_filter_ref(q, p, gamma_p, rho_p, *, eta: float, tau_min: float,
                  tau_max: float):
    """One step of the digital SP-tracking filter (12) plus telemetry.

    Returns ``(q_new, gp_sq_sum, err_sq_sum)``: ``q_new = (1-eta) q + eta p``
    in ``q``'s dtype, ``sum G_p(p)^2`` (the convergence metric of Thm 3.7)
    and ``sum (q_new - w_sp)^2`` (the SP tracking error, ``w_sp`` from the
    corrected eq. 110), both 0-d float32."""
    q_new, g2, d2 = sp_filter_terms(q, p, gamma_p, rho_p, eta=eta,
                                    tau_min=tau_min, tau_max=tau_max)
    return q_new.to(q.dtype), torch.sum(g2), torch.sum(d2)


# ---------------------------------------------------------------------------
# device parameters (App. F.1)
# ---------------------------------------------------------------------------

# the DeviceConfig fields a device draw reads
DEVICE_FIELDS = ("sigma_d2d", "sigma_pm", "ref_mean", "ref_std", "tau_min",
                 "tau_max")


def device_scalars(cfg) -> dict:
    """The ``DEVICE_FIELDS`` of a ``DeviceConfig``, as Python floats."""
    return {k: float(getattr(cfg, k)) for k in DEVICE_FIELDS}


def clip_pm(x, gamma, frac: float = 0.95):
    """clip(x, -frac*gamma, frac*gamma), element-wise bounds."""
    return torch.minimum(torch.maximum(x, -frac * gamma), frac * gamma)


def device_params_ref(normal, shape, device, *, sigma_d2d: float,
                      sigma_pm: float, ref_mean: float, ref_std: float,
                      tau_min: float, tau_max: float):
    """float32 ``(gamma, rho)`` of ``shape`` from ``normal(i)``, the standard
    normals of ``shape`` for the slope (i = 0), the asymmetry (1) and the
    target SP (2); only those the scalars read are asked for."""
    if sigma_d2d > 0:
        gamma = torch.exp(sigma_d2d * normal(0))
    else:
        gamma = torch.ones(shape, dtype=torch.float32, device=device)
    if ref_mean != 0.0 or ref_std != 0.0:
        # rho realizing a target SP w* ~ N(ref_mean, ref_std^2)
        w_star = ref_mean + ref_std * normal(2)
        w_star = torch.clamp(w_star, -0.95 * tau_min, 0.95 * tau_max)
        num = w_star * gamma * (tau_min + tau_max)
        den = 2.0 * tau_min * tau_max + w_star * (tau_min - tau_max)
        return gamma, clip_pm(num / den, gamma)
    # Def. 2.1 positive-definiteness: |rho| < gamma keeps both alpha+- > 0
    return gamma, clip_pm(sigma_pm * normal(1), gamma)
