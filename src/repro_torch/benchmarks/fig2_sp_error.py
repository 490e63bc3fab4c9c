"""Fig. 2 — training with SPs estimated from different ZS pulse budgets.

Port of the JAX package's ``benchmarks/fig2_sp_error.py``. Two-stage
Residual Learning (paper Alg. 4) on the FCN stand-in task: the static SP
estimate comes from Algorithm 1 with N pulses. Small N leaves a residual
calibration error that degrades (or stalls) training — the motivation for
dynamic tracking.

The "mirror" devices are the reference's: tile i (paths sorted) samples
from ``split(fold_in(PRNGKey(1), i), 3)[0]``, while ``trainer.init`` draws
each tile's ``dev_p`` from ``split(crc_fold(PRNGKey(seed + 1), path),
3)[0]``. So the estimates are of other draws from the same distribution,
not of the tiles' own devices (a fault of the reference, kept so that the
rows are the reference's; ``mirror_devices`` exposes the draws).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import prng
from ..core import zs
from ..core.device import DeviceConfig, sample_device
from ..core.trainer import partition_params
from ..data import ImageDataset
from ..models import convnets
from .common import device_pair, train_image_model


def mirror_devices(dev_p: DeviceConfig, device="cuda") -> Dict[str, tuple]:
    """{path: (zs key, w0 shape, device params)} of each FCN tile's mirror,
    in the reference's key order."""
    params = convnets.init_convnet(prng.PRNGKey(0),
                                   convnets.ConvNetConfig(kind="fcn"), device)
    _, analog = partition_params(params, convnets.analog_filter)
    out = {}
    for i, (p, w0) in enumerate(sorted(analog.items())):
        kk = prng.fold_in(prng.PRNGKey(1), i)
        kp, _, _ = prng.split(kk, 3)
        out[p] = (prng.fold_in(kk, 7), tuple(w0.shape),
                  sample_device(kp, w0.shape, dev_p, device=device))
    return out


def run(quick: bool = True, device="cuda") -> List[str]:
    rows = []
    dev_p, dev_w = device_pair(dw_min=0.01, ref_mean=0.3, ref_std=0.3)
    data = ImageDataset(n_train=2048 if quick else 8192, n_test=1024, seed=11)
    epochs = 2 if quick else 5

    # ground-truth-SP run needs the actual tile device draws; we instead
    # sweep the *quality* of the estimate by running ZS for N pulses on a
    # mirror of each tile's device (the reference's seed path; see above).
    budgets = [0, 100, 1000] if quick else [0, 100, 500, 2000, 8000]
    for n in budgets:
        # sp_estimates=None -> Q=0 (uncalibrated); n>0 builds per-tile
        # estimates by simulating ZS on identically-sampled devices.
        sp_estimates = None
        label = "uncalibrated" if n == 0 else f"zs_N{n}"
        if n > 0:
            sp_estimates = {
                p: zs.zs_estimate(k, torch.zeros(shape, device=device), dp,
                                  dev_p, n)
                for p, (k, shape, dp) in mirror_devices(dev_p, device).items()}
        t0 = time.time()
        res = train_image_model(
            algorithm="residual", dev_p=dev_p, dev_w=dev_w, epochs=epochs,
            data=data, sp_estimates=sp_estimates, seed=0, device=device)
        final = float(np.mean(res.losses[-20:]))
        rows.append(f"fig2_residual_{label},{(time.time()-t0)*1e6:.0f},"
                    f"final_loss={final:.4f};test_acc={res.test_acc:.4f}")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
