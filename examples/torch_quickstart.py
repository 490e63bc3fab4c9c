"""Quickstart on the PyTorch port: E-RIDER analog training on a toy problem.

The same problem, seeds and printed columns as ``examples/quickstart.py``:
f(W) = 0.5 ||W - W*||^2 with a noisy gradient, trained on devices with a
nonzero, unknown symmetric point. The SP-tracking column (sp_err) shows Q
converging to the devices' symmetric point during training.

Run on the card:  PYTHONPATH=src python examples/torch_quickstart.py
Run on the CPU:   PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import prng
from repro_torch.api import AnalogPlan, AnalogTrainer, TilePolicy, TrainerConfig
from repro_torch.core.device import DeviceConfig
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
from repro_torch.core.tile import TileConfig


def make_loss_fn(device):
    w_star = prng.normal(prng.PRNGKey(1), (32, 32), device) * 0.05

    def loss_fn(params, batch, rng):
        noise = 0.02 * prng.normal(rng, params["w"].shape, device)
        resid = params["w"] - w_star
        surrogate = torch.sum(params["w"] * (resid + noise).detach())
        return surrogate, {"true_loss": 0.5 * torch.sum(resid ** 2)}

    return loss_fn


def make_trainer(device):
    # analog devices with a nonzero, unknown symmetric point: SP ~ N(0.3, 0.2^2)
    dev_p = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1,
                         sigma_c2c=0.05, ref_mean=0.3, ref_std=0.2)
    dev_w = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1,
                         sigma_c2c=0.05)
    policy = TilePolicy(
        TileConfig(algorithm="erider", device_p=dev_p, device_w=dev_w,
                   lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.3, chopper_p=0.1),
        name="erider")
    plan = AnalogPlan.of(("**", policy))
    cfg = TrainerConfig(
        digital=DigitalOptConfig(kind="sgd"),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1),
    )
    return AnalogTrainer(make_loss_fn(device), cfg, plan=plan)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=601)
    args = ap.parse_args(argv)
    trainer = make_trainer(args.device)
    state = trainer.init(prng.PRNGKey(2),
                         {"w": torch.zeros((32, 32), device=args.device)})
    step = trainer.jit_step()

    print("step   loss     ||Q - w*||^2 (SP tracking)   pulses")
    for i in range(args.steps):
        state, m = step(state, None)
        if i % 100 == 0:
            print(f"{i:5d}  {float(m['true_loss']):7.4f}  "
                  f"{float(m['tile/sp_err']):10.4f}               "
                  f"{float(m['tile/pulses']):6.0f}")


if __name__ == "__main__":
    main()
