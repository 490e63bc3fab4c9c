"""Digital optimizers for the non-analog parameter branch.

Port of the JAX package's ``core/digital_opt.py``: SGD(+momentum) and
Adam(W) with optional global-norm clipping and weight decay, plus
constant / warmup-cosine / linear LR schedules. ``None`` leaves (analog
slots) pass through. The learning rate is a float32 0-d tensor on the host,
like the step counter it is computed from.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..kernels.ref import div
from .paths import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class DigitalOptConfig:
    kind: str = "sgdm"          # sgd | sgdm | adam | adamw
    lr_scale: float = 1.0       # multiplier on the global LR
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 0.0      # 0 = off


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "constant"      # constant | cosine | linear
    base_lr: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 1000
    min_ratio: float = 0.1


def lr_at(step, cfg: ScheduleConfig) -> torch.Tensor:
    f32 = torch.float32
    s = torch.as_tensor(step).to(f32)
    base = torch.tensor(cfg.base_lr, dtype=f32)
    warm = (torch.clamp_max(div(s + 1.0, cfg.warmup_steps), 1.0)
            if cfg.warmup_steps > 0 else 1.0)
    if cfg.kind == "constant":
        decay = 1.0
    elif cfg.kind in ("cosine", "linear"):
        span = max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.clamp(div(s - cfg.warmup_steps, span), 0.0, 1.0)
        if cfg.kind == "cosine":
            decay = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (
                1 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - (1 - cfg.min_ratio) * frac
    else:
        raise ValueError(cfg.kind)
    return base * warm * decay


def init_opt(params, cfg: DigitalOptConfig) -> Dict[str, Any]:
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    if cfg.kind == "sgdm":
        return {"mu": zeros()}
    if cfg.kind in ("adam", "adamw"):
        return {"mu": zeros(), "nu": zeros()}
    return {}


def clip_by_global_norm(grads, max_norm: float):
    # a float32 zero to start from: a tree with no leaves has norm 0
    gnorm = torch.sqrt(sum((torch.sum(torch.square(g.to(torch.float32)))
                            for g in leaves(grads)),
                           torch.zeros((), dtype=torch.float32)))
    # tensor / tensor: torch's float / tensor multiplies by the reciprocal
    scale = torch.clamp_max(torch.full_like(gnorm, max_norm) / (gnorm + 1e-12),
                            1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def apply_opt(params, grads, opt, step, lr, cfg: DigitalOptConfig,
              inplace: bool = False):
    """Update the digital branch; returns (params, opt, grad_norm).
    ``inplace=True`` writes the parameters and moments into their own
    storage (``out=``: each result rounds once, at the store into the
    leaf's dtype, as ``.to(p.dtype)`` rounds it) and returns the given
    trees."""
    f32 = torch.float32
    lr = lr * cfg.lr_scale
    gnorm = torch.zeros((), dtype=f32)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    def sub_into(p, delta):
        """p - delta in float32, in p's dtype (into p in place)."""
        if inplace:
            return torch.sub(p.to(f32), delta, out=p)
        return (p.to(f32) - delta).to(p.dtype)

    def add_into(dst, a, b):
        return torch.add(a, b, out=dst) if inplace else a + b

    if cfg.kind == "sgd":
        new_params = tree_map(lambda p, g: sub_into(p, lr * g), params, grads)
        return new_params, opt, gnorm
    if cfg.kind == "sgdm":
        new_mu = tree_map(
            lambda p, g, m: add_into(m, cfg.momentum * m, g.to(f32)),
            params, grads, opt["mu"])
        new_params = tree_map(lambda p, m: sub_into(p, lr * m), params, new_mu)
        return new_params, {"mu": new_mu}, gnorm
    if cfg.kind in ("adam", "adamw"):
        t = torch.as_tensor(step).to(f32) + 1.0
        new_mu = tree_map(
            lambda p, g, m: add_into(m, cfg.beta1 * m,
                                     (1 - cfg.beta1) * g.to(f32)),
            params, grads, opt["mu"])
        new_nu = tree_map(
            lambda p, g, v: add_into(v, cfg.beta2 * v,
                                     (1 - cfg.beta2) * torch.square(g.to(f32))),
            params, grads, opt["nu"])
        bc1 = 1 - torch.pow(torch.tensor(cfg.beta1, dtype=f32), t)
        bc2 = 1 - torch.pow(torch.tensor(cfg.beta2, dtype=f32), t)

        def adam_step(p, m, v):
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.kind == "adamw" and cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * p.to(f32)
            return sub_into(p, lr * delta)

        new_params = tree_map(adam_step, params, new_mu, new_nu)
        return new_params, {"mu": new_mu, "nu": new_nu}, gnorm
    raise ValueError(cfg.kind)
