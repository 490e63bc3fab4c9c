"""Set-up shared by the port's on-card runs (``chip_smoke.py``,
``repro_torch.benchmarks.step_profile``) and its tests.

The paper's own workload as the JAX package's ``benchmarks/common.py`` runs
it: the fully analog FCN 784-256-128-10 at full width, E-RIDER with
``ALGO_HP["erider"]`` on ``device_pair()`` devices, sgdm(0.5) on the
digital biases, constant LR 0.2, batch 64 of the procedural MNIST stand-in
(seed 11).
"""
from __future__ import annotations

import torch

from .. import prng
from ..core.device import PRESETS, DeviceConfig
from ..core.digital_opt import DigitalOptConfig, ScheduleConfig
from ..core.plan import AnalogPlan, TilePolicy
from ..core.tile import TileConfig
from ..core.trainer import AnalogTrainer, TrainerConfig
from ..data import ImageDataset
from ..models import convnets

# the JAX package's benchmarks/common.py: device_pair() and ALGO_HP["erider"]
FCN_DEVICE = dict(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.1)
ERIDER_HP = dict(grad_norm="absmean", buffered_transfer=True, lr_p=5.0,
                 lr_w=0.2, gamma=0.1, eta=0.05, chopper_p=0.1)


def fcn_trainer(backend: str, preset: str = "") -> AnalogTrainer:
    """The FCN's E-RIDER trainer under ``update_backend=backend``, on the
    benchmark's devices or on the named ``PRESETS`` entry."""
    dev = PRESETS[preset] if preset else DeviceConfig(**FCN_DEVICE)
    tile = TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                      update_backend=backend, **ERIDER_HP)
    return AnalogTrainer(
        convnets.make_loss_fn(convnets.ConvNetConfig()),
        TrainerConfig(tile=tile,
                      digital=DigitalOptConfig(kind="sgdm", momentum=0.5),
                      schedule=ScheduleConfig(kind="constant", base_lr=0.2)),
        plan=AnalogPlan.of((convnets.analog_filter,
                            TilePolicy(tile, name="erider")),
                           analog_min_ndim=0))


def fcn_run(backend: str, device, steps: int, seed: int = 0):
    """(trainer, initial state, ``steps`` batches on ``device``)."""
    trainer = fcn_trainer(backend)
    params = convnets.init_convnet(prng.PRNGKey(seed), convnets.ConvNetConfig(),
                                   device)
    state = trainer.init(prng.PRNGKey(seed + 1), params)
    data = ImageDataset(n_train=steps * 64, n_test=64, seed=11)
    batches = [{"x": torch.as_tensor(b["x"], device=device),
                "y": torch.as_tensor(b["y"], device=device)}
               for b in data.epoch(0, 64)]
    return trainer, state, batches[:steps]
