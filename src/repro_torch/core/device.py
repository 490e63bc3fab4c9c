"""Analog resistive-device models (paper §4 "Device model" + App. F.1).

Port of the JAX package's ``core/device.py``: the SoftBoundsReference family
(AIHWKit presets, paper Table 3) plus the linear and exponential families of
Def. 2.1 / C.1, per-element device-to-device sampling

    gamma_ij = exp(sigma_d2d * xi),   rho_ij = sigma_pm * xi',

and the closed-form symmetric point (G(w) = 0)

    w_sp = (alpha+ - alpha-) / (alpha+/tau_max + alpha-/tau_min).

Device parameters are a plain dict ``{"gamma": tensor, "rho": tensor}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import prng
from ..kernels import fastrng
from ..kernels import ref as kref
from .paths import TensorSpec

DeviceParams = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Static description of a device family/preset."""

    kind: str = "softbounds"      # softbounds | linear | exp
    tau_min: float = 1.0          # lower bound is -tau_min (tau_min > 0)
    tau_max: float = 1.0
    dw_min: float = 0.001         # response granularity
    sigma_d2d: float = 0.0        # d2d slope variation (lognormal sigma)
    sigma_pm: float = 0.0         # d2d asymmetry variation
    sigma_c2c: float = 0.0        # cycle-to-cycle write noise
    # nonzero-SP initialization (Tables 1-2): per-element SP ~ N(mean, std^2)
    ref_mean: float = 0.0
    ref_std: float = 0.0
    exp_kappa: float = 0.5        # exp-family curvature (kind == "exp")
    # lifetime physics (drift, programming and read noise); no-op defaults
    drift_nu: float = 0.0
    drift_nu_std: float = 0.0
    drift_t0: float = 1.0
    prog_noise: float = 0.0
    prog_noise_slope: float = 0.0
    prog_rounds: int = 1
    read_noise: float = 0.0

    @property
    def num_states(self) -> float:
        """Number of conductance states across the dynamic range."""
        return (self.tau_max + self.tau_min) / self.dw_min


PRESETS = {
    # HfO2-based ReRAM (Gong et al., 2022b): very few states (~4-5)
    "reram_hfo2": DeviceConfig(
        kind="softbounds", tau_min=1.0, tau_max=1.0, dw_min=0.4622,
        sigma_d2d=0.1, sigma_pm=0.7125, sigma_c2c=0.2174,
        drift_nu=0.01, drift_nu_std=0.004, prog_noise=0.02,
        prog_noise_slope=0.05, read_noise=0.01,
    ),
    # ReRamArrayOMPresetDevice (Gong et al., 2022b)
    "reram_om": DeviceConfig(
        kind="softbounds", tau_min=1.0, tau_max=1.0, dw_min=0.0949,
        sigma_d2d=0.1, sigma_pm=0.7829, sigma_c2c=0.4158,
        drift_nu=0.01, drift_nu_std=0.004, prog_noise=0.01,
        prog_noise_slope=0.04, read_noise=0.005,
    ),
    # high-precision device of the ZS complexity study (Fig. 1)
    "softbounds_2000": DeviceConfig(
        kind="softbounds", tau_min=1.0, tau_max=1.0, dw_min=0.001,
        sigma_d2d=0.1, sigma_pm=0.3, sigma_c2c=0.05,
        drift_nu=0.005, drift_nu_std=0.002, prog_noise=0.002,
        prog_noise_slope=0.01, read_noise=0.002,
    ),
    # ECRAM-style preset: ~1000 states, milder asymmetry, nonzero write noise
    "ecram": DeviceConfig(
        kind="softbounds", tau_min=1.0, tau_max=1.0, dw_min=0.002,
        sigma_d2d=0.1, sigma_pm=0.25, sigma_c2c=0.15,
        drift_nu=0.002, drift_nu_std=0.001, prog_noise=0.004,
        prog_noise_slope=0.02, read_noise=0.002,
    ),
    # mushroom-cell d-GST PCM: the canonical drifting device
    "pcm_gst": DeviceConfig(
        kind="softbounds", tau_min=1.0, tau_max=1.0, dw_min=0.005,
        sigma_d2d=0.1, sigma_pm=0.3, sigma_c2c=0.05,
        drift_nu=0.06, drift_nu_std=0.02, drift_t0=20.0,
        prog_noise=0.01, prog_noise_slope=0.07, prog_rounds=3,
        read_noise=0.005,
    ),
    # idealized symmetric device (digital-like reference)
    "ideal": DeviceConfig(
        kind="softbounds", tau_min=10.0, tau_max=10.0, dw_min=1e-6,
        sigma_d2d=0.0, sigma_pm=0.0, sigma_c2c=0.0,
    ),
}


def _clip_pm(x, gamma, frac: float = 0.95):
    """clip(x, -frac*gamma, frac*gamma), element-wise bounds."""
    return torch.minimum(torch.maximum(x, -frac * gamma), frac * gamma)


def sample_device(key, shape, cfg: DeviceConfig, method: str = "threefry",
                  device="cuda") -> DeviceParams:
    """Per-element (gamma, rho) for a tile of ``shape`` (App. F.1).
    ``method='hash'`` draws from the fastrng hash (salts 11/13/17); there a
    ``(n, 2)`` batch of keys samples ``(n, *shape)``, row i as key i
    alone."""
    shape = tuple(int(d) for d in shape)
    if method == "hash":
        seed = fastrng.seed_from_key(key)
        n_g = fastrng.hash_normal(seed, shape, 11, device)
        n_r = fastrng.hash_normal(seed, shape, 13, device)
        n_s = fastrng.hash_normal(seed, shape, 17, device)
    else:
        kg, kr, ks = prng.split(key, 3)
        n_g = prng.normal(kg, shape, device)
        n_r = prng.normal(kr, shape, device)
        n_s = prng.normal(ks, shape, device)
    if cfg.sigma_d2d > 0:
        gamma = torch.exp(cfg.sigma_d2d * n_g)
    else:
        gamma = torch.ones_like(n_g)
    # Def. 2.1 positive-definiteness: |rho| < gamma keeps both alpha+- > 0
    rho = _clip_pm(cfg.sigma_pm * n_r, gamma)

    if cfg.ref_mean != 0.0 or cfg.ref_std != 0.0:
        # rho realizing a target SP w* ~ N(ref_mean, ref_std^2)
        w_star = cfg.ref_mean + cfg.ref_std * n_s
        w_star = torch.clamp(w_star, -0.95 * cfg.tau_min, 0.95 * cfg.tau_max)
        num = w_star * gamma * (cfg.tau_min + cfg.tau_max)
        den = (2.0 * cfg.tau_min * cfg.tau_max
               + w_star * (cfg.tau_min - cfg.tau_max))
        rho = _clip_pm(num / den, gamma)
    return {"gamma": gamma, "rho": rho}


def abstract_device(shape, dtype=torch.float32, device="cuda") -> DeviceParams:
    """TensorSpec stand-in of ``sample_device``'s result (no allocation)."""
    s = TensorSpec(tuple(shape), dtype, device)
    return {"gamma": s, "rho": s}


# ---------------------------------------------------------------------------
# response functions
# ---------------------------------------------------------------------------


def responses(w, dp: DeviceParams, cfg: DeviceConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_plus, q_minus) for the device family, floored at 1e-4 (Def. 2.1
    positive-definiteness; ``kernels/ref.py`` and the kernel have no
    floor)."""
    gamma, rho = dp["gamma"], dp["rho"]
    if cfg.kind in ("softbounds", "linear"):
        qp = kref.q_plus(w, gamma, rho, cfg.tau_max)
        qm = kref.q_minus(w, gamma, rho, cfg.tau_min)
    elif cfg.kind == "exp":
        # monotone exponential family (Def. C.1)
        qp = (gamma + rho) * torch.exp(kref.div(-cfg.exp_kappa * w, cfg.tau_max))
        qm = (gamma - rho) * torch.exp(kref.div(cfg.exp_kappa * w, cfg.tau_min))
    else:
        raise ValueError(f"unknown device kind {cfg.kind}")
    eps = 1e-4
    return torch.clamp_min(qp, eps), torch.clamp_min(qm, eps)


def fg(w, dp: DeviceParams, cfg: DeviceConfig):
    qp, qm = responses(w, dp, cfg)
    return (qm + qp) * 0.5, (qm - qp) * 0.5


def symmetric_point(dp: DeviceParams, cfg: DeviceConfig):
    """Ground-truth SP (G(w) = 0): closed form for softbounds; for the exp
    family w_sp solves (gamma-rho) e^{k w/tmin} = (gamma+rho) e^{-k w/tmax}."""
    gamma, rho = dp["gamma"], dp["rho"]
    a_p = gamma + rho
    a_m = gamma - rho
    if cfg.kind in ("softbounds", "linear"):
        return (a_p - a_m) / (kref.div(a_p, cfg.tau_max)
                              + kref.div(a_m, cfg.tau_min))
    if cfg.kind == "exp":
        k = cfg.exp_kappa
        return kref.div(torch.log(a_p / a_m), k / cfg.tau_min + k / cfg.tau_max)
    raise ValueError(cfg.kind)
