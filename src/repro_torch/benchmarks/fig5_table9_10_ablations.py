"""Fig. 5 + Tables 9-10 — E-RIDER hyper-parameter ablations.

Port of the JAX package's ``benchmarks/fig5_table9_10_ablations.py``.

Fig. 5:   chopper probability p (p=0 degrades E-RIDER to RIDER).
Table 9:  moving-average stepsize eta.
Table 10: residual perturbation gamma (large gamma destabilizes).
"""
from __future__ import annotations

import time
from typing import List

from .common import device_pair, train_image_model


def _sweep(name: str, param: str, values, quick: bool, device) -> List[str]:
    rows = []
    dev_p, dev_w = device_pair(dw_min=0.25, sigma_pm=0.5, sigma_c2c=0.2,
                               ref_mean=0.3, ref_std=0.3)
    epochs = 2 if quick else 4
    for v in values:
        t0 = time.time()
        res = train_image_model(
            algorithm="erider", dev_p=dev_p, dev_w=dev_w, epochs=epochs,
            hp_overrides={param: v}, seed=3, device=device)
        sp = f";sp_err={res.sp_err:.4f}" if res.sp_err is not None else ""
        rows.append(f"{name}_{param}{v},{(time.time()-t0)*1e6:.0f},"
                    f"test_acc={res.test_acc:.4f}{sp}")
    return rows


def run(quick: bool = True, device="cuda") -> List[str]:
    rows = []
    ps = [0.0, 0.1] if quick else [0.0, 0.02, 0.05, 0.1, 0.2, 0.5]
    rows += _sweep("fig5_chopper", "chopper_p", ps, quick, device)
    etas = [0.05, 0.4] if quick else [0.01, 0.05, 0.2, 0.4, 0.6, 1.0]
    rows += _sweep("table9_eta", "eta", etas, quick, device)
    gammas = [0.1, 0.5] if quick else [0.05, 0.1, 0.2, 0.4, 0.5, 0.7]
    rows += _sweep("table10_gamma", "gamma", gammas, quick, device)
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
