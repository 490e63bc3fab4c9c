"""Fig. 1 — ZS pulse-budget vs SP-estimation accuracy trade-off.

Port of the JAX package's ``benchmarks/fig1_zs.py``.

(a) offsets of the estimated SP mean/std vs pulse budget N on a device
    array (paper: 512x512; reduced here), dw_min = 0.001.
(b) smallest N reaching <=1% relative mean error as dw_min shrinks —
    Thm 2.2's N = O(1/(delta * dw_min)) scaling.

``zs.zs_estimate`` is a Python loop over pulses (a host key split and a
few launches per pulse), so (b) at dw_min 0.0025 issues up to 32 000
pulses' worth of launches.
"""
from __future__ import annotations

import time
from typing import List

import torch

from .. import prng
from ..core import zs
from ..core.device import DeviceConfig, sample_device, symmetric_point


def _std(x: torch.Tensor) -> float:
    return float(torch.std(x, correction=0))  # jnp.std


def run(quick: bool = True, device="cuda") -> List[str]:
    rows = []
    side = 64 if quick else 256
    key = prng.PRNGKey(0)

    # (a) offset vs pulse budget
    cfg = DeviceConfig(dw_min=0.001, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
    dp = sample_device(key, (side, side), cfg, device=device)
    sp = symmetric_point(dp, cfg)
    true_mean, true_std = float(torch.mean(sp)), _std(sp)
    budgets = [250, 500, 1000, 2000, 4000] if quick else [500, 1000, 2000, 4000, 8000]
    # tail_average=False: each chunk resumes Algorithm 1 from the device's
    # actual last iterate (an averaged state is not physically realizable as
    # a resume point, and re-averaging would compound across chunks)
    est = torch.zeros((side, side), device=device)
    done = 0
    t0 = time.time()
    for n in budgets:
        est = zs.zs_estimate(prng.fold_in(key, n), est, dp, cfg,
                             n - done, tail_average=False)
        done = n
        mean_off = true_mean - float(torch.mean(est))
        std_off = true_std - _std(est)
        rel_err = abs(mean_off) / max(abs(true_mean), 1e-9)
        rows.append(f"fig1a_zs_offset_N{n},{(time.time()-t0)*1e6:.0f},"
                    f"mean_off={mean_off:.5f};std_off={std_off:.5f};rel={rel_err:.3f}")

    # (b) pulses to 1% mean error vs dw_min
    dwmins = [0.02, 0.01, 0.005, 0.0025] if quick else [0.02, 0.01, 0.005, 0.0025, 0.00125]
    for dw in dwmins:
        cfg2 = DeviceConfig(dw_min=dw, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
        dp2 = sample_device(prng.fold_in(key, 99), (side, side), cfg2,
                            device=device)
        sp2 = symmetric_point(dp2, cfg2)
        tm = float(torch.mean(sp2))
        t0 = time.time()
        w = torch.zeros((side, side), device=device)
        n_total = 0
        found = -1
        chunk_n = max(200, int(0.2 / dw))
        while n_total < 80 / dw:
            w = zs.zs_estimate(prng.fold_in(key, n_total), w, dp2, cfg2,
                               chunk_n, tail_average=False)
            n_total += chunk_n
            if abs(tm - float(torch.mean(w))) / max(abs(tm), 1e-9) <= 0.01:
                found = n_total
                break
        rows.append(f"fig1b_pulses_to_1pct_dwmin{dw},{(time.time()-t0)*1e6:.0f},"
                    f"N={found};pred_scaling=1/dwmin")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
