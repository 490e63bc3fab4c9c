"""Paper §4 end-to-end: fully-analog FCN trained with E-RIDER vs TT-v2.

The PyTorch port's counterpart of ``examples/analog_mnist.py``. Reproduces
the Tables 1-2 story at example scale: on low-state devices (~4
conductance states) with a nonzero symmetric-point reference, the
static-calibration baseline (TT-v2) degrades while E-RIDER dynamically
tracks the SP and trains through it.

Run on the card (TF32 off):  PYTHONPATH=src python examples/torch_analog_mnist.py
On the CPU:                  PYTHONPATH=src python examples/torch_analog_mnist.py --device cpu
"""
import argparse
import sys

import torch

from repro_torch.benchmarks.common import (card_line, device_pair,
                                           train_image_model)
from repro_torch.data import ImageDataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu to run on the CPU)")
        print(f"card: {card_line()}")  # train_image_model turns TF32 off
    data = ImageDataset(n_train=4096, n_test=1024, seed=11)
    dev_p, dev_w = device_pair(dw_min=0.4622, sigma_pm=0.7125,
                               sigma_c2c=0.2174, ref_mean=0.4, ref_std=0.4)
    print("device: ~4 states (dw_min=0.4622), SP reference ~ N(0.4, 0.4^2)\n")
    results = {}
    for algo in ("ttv2", "agad", "erider"):
        res = train_image_model(algorithm=algo, dev_p=dev_p, dev_w=dev_w,
                                epochs=2, data=data, seed=1,
                                device=args.device)
        sp = f"  sp_err={res.sp_err:.4f}" if res.sp_err is not None else ""
        print(f"{algo:8s} test_acc={res.test_acc:.3f}  "
              f"pulses={res.pulses:.2e}  wall={res.wall_s:.0f}s{sp}")
        results[algo] = res
    return results


if __name__ == "__main__":
    main()
