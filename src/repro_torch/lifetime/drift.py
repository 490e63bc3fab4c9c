"""Conductance drift and programming error over effective weights.

Port of the JAX package's ``lifetime/drift.py`` (Rasch et al. HWA
replications, generalized to any ``DeviceConfig`` preset):

  programming   one write lands at ``w + N(0, sigma_p(w)^2)`` with
                ``sigma_p(w) = prog_noise + prog_noise_slope * |w|``; each
                verify round reads back through ``read_noise`` and makes a
                corrective write whose error is proportional to the
                correction.
  drift         ``W(t) = W(t0) * (t/t0)^-nu``, a frozen per-element
                ``nu ~ N(drift_nu, drift_nu_std^2)`` clipped at 0.
  read noise    additive ``N(0, read_noise^2)`` on any post-t0 read, in
                units of the tensor's amplitude ``amax(|w|)``.

Every draw is a ``kernels.fastrng`` hash of (seed, salt), frozen per
deployment: reading twice at the same ``t`` gives the same array. The salts
are the reference's, so both packages draw from the same streams.

``t == cfg.drift_t0`` is a bit-exact no-op: ``torch.where`` picks the input
on the exact time match, on the CPU and on the card. ``log(max(t, t0) /
t0)`` runs on f32 0-d tensors divided tensor by tensor (torch's CUDA
``tensor / python_float`` multiplies by the reciprocal).
"""
from __future__ import annotations

import zlib
from typing import Dict

import torch

from .. import prng
from ..core.device import DeviceConfig
from ..core.paths import tree_map_with_path
from ..kernels import fastrng

# fastrng salts: core/device.py owns 11/13/17; lifetime draws live at 23+
SALT_NU = 23          # per-element drift exponent (frozen per deployment)
SALT_READ = 29        # read noise at age t (frozen per deployment)
SALT_PROG = 31        # programming write error, round r -> SALT_PROG + 2r
SALT_VERIFY = 37      # verify-read error, round r -> SALT_VERIFY + 2r


def path_key(key, name: str):
    """Per-path key: fold a CRC of ``name`` into ``key``, as the trainer's
    per-tile keys do."""
    return prng.fold_in(key, zlib.crc32(name.encode()))


def has_lifetime(cfg: DeviceConfig) -> bool:
    """True when the preset models any post-training non-ideality."""
    return (cfg.drift_nu != 0.0 or cfg.drift_nu_std != 0.0
            or cfg.read_noise != 0.0 or cfg.prog_noise != 0.0
            or cfg.prog_noise_slope != 0.0)


def apply_lifetime(w_eff: torch.Tensor, t, key, cfg: DeviceConfig) -> torch.Tensor:
    """Read ``w_eff`` (programmed at ``cfg.drift_t0``) at ``t`` seconds after
    programming, on ``w_eff``'s device. Exactly ``w_eff`` when ``t ==
    cfg.drift_t0``; ``t`` is clamped below at t0."""
    if not has_lifetime(cfg):
        return w_eff
    seed = fastrng.seed_from_key(key)
    shape, dev, f32 = tuple(w_eff.shape), w_eff.device, torch.float32
    nu = cfg.drift_nu + cfg.drift_nu_std * fastrng.hash_normal(
        seed, shape, SALT_NU, dev)
    nu = torch.clamp_min(nu, 0.0)
    t = torch.as_tensor(t, dtype=f32, device=dev)
    t0 = torch.tensor(cfg.drift_t0, dtype=f32, device=dev)
    # (t/t0)^-nu via exp/log: exactly 1.0 at t == t0 (log(1) == 0)
    log_ratio = torch.log(torch.maximum(t, t0) / t0)
    aged = w_eff * torch.exp(-nu * log_ratio)
    if cfg.read_noise:
        unit = torch.max(torch.abs(w_eff))
        aged = aged + cfg.read_noise * unit * fastrng.hash_normal(
            seed, shape, SALT_READ, dev)
    return torch.where(t == t0, w_eff, aged).to(w_eff.dtype)


def program_weights(w_aim: torch.Tensor, key, cfg: DeviceConfig) -> torch.Tensor:
    """Write-and-verify programming of ``w_aim``: the conductance state
    standing at ``cfg.drift_t0``. Round 0 writes with error ``sigma_p(w)``;
    each later round reads back through ``read_noise`` and corrects with an
    error ``0.1 * prog_noise + prog_noise_slope * |correction|``."""
    if cfg.prog_noise == 0.0 and cfg.prog_noise_slope == 0.0:
        return w_aim
    seed = fastrng.seed_from_key(key)
    shape, dev = tuple(w_aim.shape), w_aim.device
    sigma0 = cfg.prog_noise + cfg.prog_noise_slope * torch.abs(w_aim)
    w = w_aim + sigma0 * fastrng.hash_normal(seed, shape, SALT_PROG, dev)
    floor = 0.1 * cfg.prog_noise
    for r in range(1, max(int(cfg.prog_rounds), 1)):
        read = w + cfg.read_noise * fastrng.hash_normal(
            seed, shape, SALT_VERIFY + 2 * r, dev)
        delta = w_aim - read
        sigma_c = floor + cfg.prog_noise_slope * torch.abs(delta)
        w = w + delta + sigma_c * fastrng.hash_normal(
            seed, shape, SALT_PROG + 2 * r, dev)
    tau = min(cfg.tau_min, cfg.tau_max)
    if cfg.kind == "softbounds" and tau > 0:
        w = torch.clamp(w, -cfg.tau_min, cfg.tau_max)
    return w.to(w_aim.dtype)


def lifetime_cfg_map(params, tiles, default_cfg: DeviceConfig) -> Dict[str, DeviceConfig]:
    """{path: DeviceConfig} for every analog leaf of the merged effective
    params: each TileBank member maps to its stack's ``device_w`` preset;
    digital leaves are absent (silicon does not drift)."""
    out: Dict[str, DeviceConfig] = {}
    for g, paths in tiles.index:
        pol = tiles.policy(g)
        if pol is not None and pol.is_digital:
            continue
        cfg = pol.tile.device_w if pol is not None else default_cfg
        for p in paths:
            out[p] = cfg
    return out


def age_params(params, cfg_map: Dict[str, DeviceConfig], age_s: float, key):
    """Age every analog leaf of a merged effective-params tree to ``t =
    drift_t0 + age_s`` under its own preset; leaves without a ``cfg_map``
    entry pass through. ``age_s == 0`` returns every leaf bit-exactly."""
    def age(p, leaf):
        cfg = cfg_map.get(p)
        if leaf is None or cfg is None:
            return leaf
        return apply_lifetime(leaf, cfg.drift_t0 + float(age_s),
                              path_key(key, p), cfg)
    return tree_map_with_path(age, params, keep_none=True)
