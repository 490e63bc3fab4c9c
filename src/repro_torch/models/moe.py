"""The dense MLP of the transformer blocks.

Port of ``init_mlp`` / ``mlp_forward`` of the JAX package's
``models/moe.py`` (GLU or not). The routed experts of that module come with
a later slice.
"""
from __future__ import annotations

from typing import Dict

from .. import prng
from ..configs.base import ModelConfig
from .common import activation, dense_init, dot


def init_mlp(key, cfg: ModelConfig, device="cuda") -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 3)
    p = {
        "wi": dense_init(ks[0], (d, ff), cfg.dtype, device=device),
        "wo": dense_init(ks[1], (ff, d), cfg.dtype, fan_in=ff, device=device),
    }
    if cfg.glu:
        p["wg"] = dense_init(ks[2], (d, ff), cfg.dtype, device=device)
    return p


def mlp_forward(p, x, cfg: ModelConfig):
    h = dot(x, p["wi"])
    if cfg.glu:
        h = activation(h, cfg.activation) * dot(x, p["wg"])
    else:
        h = activation(h, cfg.activation)
    return dot(h, p["wo"])
