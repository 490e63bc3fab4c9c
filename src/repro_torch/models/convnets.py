"""The paper's fully-analog FCN (App. F.3): 784 -> 256 -> 128 -> 10 with
sigmoid hidden activations. Port of the FCN branch of the JAX package's
``models/convnets.py``; all weight matrices are analog-tileable, biases stay
digital. LeNet-5 is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import prng


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    kind: str = "fcn"          # fcn | lenet5 (not ported yet)
    n_classes: int = 10
    image_size: int = 28
    channels: int = 1


def _fcn_only(cfg: ConvNetConfig) -> None:
    if cfg.kind != "fcn":
        raise NotImplementedError(f"{cfg.kind!r} is not ported yet (FCN only)")


def init_convnet(key, cfg: ConvNetConfig, device="cuda") -> Dict:
    """Parameters from a host key, drawn as ``jax.random`` draws them
    (truncated normal in [-2, 2] scaled by fan_in**-0.5)."""
    _fcn_only(cfg)
    ks = prng.split(key, 8)

    def dense(k, shape):
        std = shape[0] ** -0.5
        return std * prng.truncated_normal(k, -2, 2, shape, device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    d_in = cfg.image_size * cfg.image_size * cfg.channels
    return {
        "fc1": {"w": dense(ks[0], (d_in, 256)), "b": zeros(256)},
        "fc2": {"w": dense(ks[1], (256, 128)), "b": zeros(128)},
        "out": {"w": dense(ks[2], (128, cfg.n_classes)), "b": zeros(cfg.n_classes)},
    }


def convnet_logits(params, images, cfg: ConvNetConfig):
    """images: (B, H, W, C) float32."""
    _fcn_only(cfg)
    x = images.reshape(images.shape[0], -1)
    x = torch.sigmoid(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.sigmoid(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def make_loss_fn(cfg: ConvNetConfig):
    def loss_fn(params, batch, rng) -> Tuple[torch.Tensor, Dict]:
        logits = convnet_logits(params, batch["x"], cfg)
        labels = batch["y"].long()
        logp = F.log_softmax(logits, dim=-1)
        ce = -torch.mean(torch.gather(logp, -1, labels[:, None]))
        acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
        return ce, {"accuracy": acc}

    return loss_fn


def analog_filter(path: str, leaf) -> bool:
    """All weight matrices are analog (fully-analog nets, paper §4)."""
    return path.endswith("/w")
