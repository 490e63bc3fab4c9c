"""Tables 1-2 — robustness to nonzero SP reference (mean/std sweep).

Port of the JAX package's ``benchmarks/table12_robustness.py``. TT-v2 vs
AGAD vs E-RIDER on the FCN (Table 2) and LeNet-5 (Table 1) stand-in tasks
across reference mean/std offsets of the gradient-array device. Paper
claim to reproduce: TT-v2 degrades sharply with offset; AGAD is robust;
E-RIDER is best everywhere.
"""
from __future__ import annotations

import time
from typing import List

from .common import device_pair, train_image_model


def run(quick: bool = True, device="cuda") -> List[str]:
    rows = []
    if quick:
        grid = [(0.0, 0.05), (0.3, 0.4)]
        models = ["fcn"]
        epochs = 2
    else:
        grid = [(0.0, 0.05), (0.0, 0.4), (0.2, 0.4), (0.3, 0.4), (0.4, 1.0)]
        models = ["fcn", "lenet5"]
        epochs = 4
    algos = ["ttv2", "agad", "erider"]
    for model_kind in models:
        for mean, std in grid:
            dev_p, dev_w = device_pair(dw_min=0.4622, sigma_pm=0.7125,
                                       sigma_c2c=0.2174, ref_mean=mean, ref_std=std)
            for algo in algos:
                t0 = time.time()
                res = train_image_model(
                    algorithm=algo, model_kind=model_kind, dev_p=dev_p,
                    dev_w=dev_w, epochs=epochs, seed=1, device=device)
                sp = f";sp_err={res.sp_err:.4f}" if res.sp_err is not None else ""
                rows.append(
                    f"table12_{model_kind}_m{mean}_s{std}_{algo},"
                    f"{(time.time()-t0)*1e6:.0f},"
                    f"test_acc={res.test_acc:.4f}{sp}")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
