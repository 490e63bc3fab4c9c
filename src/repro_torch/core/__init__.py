"""Core analog in-memory training library (port of ``repro.core``).

  device.py      — resistive device models + d2d sampling + SP ground truth
  pulse.py       — Analog Update (eq. 2) pulse engine (fused / pulse-train)
  tile.py        — analog tile state, TileConfig, class-keyed TileBank
  plan.py        — AnalogPlan / TilePolicy: per-path policy rules
  algorithms.py  — SGD / TT-v1 / TT-v2 / AGAD / Residual / RIDER / E-RIDER
  digital_opt.py — digital-branch optimizers + LR schedules
  paths.py       — parameter paths and tree walking in JAX's leaf order
  trainer.py     — AnalogTrainer: model <-> tiles wiring, train_step
"""
from . import algorithms, device, digital_opt, paths, plan, pulse, tile, trainer  # noqa: F401
from .device import PRESETS, DeviceConfig, sample_device, symmetric_point  # noqa: F401
from .plan import DIGITAL, AnalogPlan, TilePolicy  # noqa: F401
from .tile import TileConfig, init_tile  # noqa: F401
from .trainer import AnalogTrainer, TrainerConfig  # noqa: F401
