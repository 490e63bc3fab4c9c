"""The paper's own workloads: fully-analog FCN and LeNet-5 (App. F.3).

FCN:     784 -> 256 -> 128 -> 10, sigmoid hidden activations.
LeNet-5: conv5x5(16) -> pool -> conv5x5(32) -> pool -> fc512 -> fc128 -> 10,
         tanh hidden activations.

Port of the JAX package's ``models/convnets.py``. Both expose init/loss
compatible with ``core.trainer.AnalogTrainer``; all matmul/conv weights are
analog-tileable (biases stay digital). Images are NHWC and convolution
kernels HWIO, as in the reference, so tiles, checkpoints and the draws made
at ``w.shape`` are the reference's; the convolution permutes to torch's
NCHW x OIHW at the call (zero-copy: the NHWC tensor is a channels-last
NCHW one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import prng


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    kind: str = "fcn"          # fcn | lenet5
    n_classes: int = 10
    image_size: int = 28
    channels: int = 1


def init_convnet(key, cfg: ConvNetConfig, device="cuda") -> Dict:
    """Parameters from a host key, drawn as ``jax.random`` draws them
    (truncated normal in [-2, 2] scaled by fan_in**-0.5)."""
    ks = prng.split(key, 8)

    def dense(k, shape):
        std = shape[0] ** -0.5
        return std * prng.truncated_normal(k, -2, 2, shape, device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    if cfg.kind == "fcn":
        d_in = cfg.image_size * cfg.image_size * cfg.channels
        return {
            "fc1": {"w": dense(ks[0], (d_in, 256)), "b": zeros(256)},
            "fc2": {"w": dense(ks[1], (256, 128)), "b": zeros(128)},
            "out": {"w": dense(ks[2], (128, cfg.n_classes)),
                    "b": zeros(cfg.n_classes)},
        }
    if cfg.kind == "lenet5":
        def conv(k, shape):  # HWIO
            fan_in = shape[0] * shape[1] * shape[2]
            return fan_in ** -0.5 * prng.truncated_normal(k, -2, 2, shape,
                                                          device)

        s = cfg.image_size // 4  # two 2x2 pools
        return {
            "conv1": {"w": conv(ks[0], (5, 5, cfg.channels, 16)),
                      "b": zeros(16)},
            "conv2": {"w": conv(ks[1], (5, 5, 16, 32)), "b": zeros(32)},
            "fc1": {"w": dense(ks[2], (s * s * 32, 512)), "b": zeros(512)},
            "fc2": {"w": dense(ks[3], (512, 128)), "b": zeros(128)},
            "out": {"w": dense(ks[4], (128, cfg.n_classes)),
                    "b": zeros(cfg.n_classes)},
        }
    raise ValueError(cfg.kind)


def _conv2d(x, w, b):
    """NHWC x HWIO -> NHWC, stride 1, SAME padding (odd kernels)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(w.shape[0] // 2, w.shape[1] // 2))
    return y.permute(0, 2, 3, 1) + b


def _maxpool(x):
    """2x2 max over NHWC, VALID; a tied window's gradient goes to its first
    maximum in row-major order, as XLA's ``select_and_scatter`` routes it."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def convnet_logits(params, images, cfg: ConvNetConfig):
    """images: (B, H, W, C) float32."""
    if cfg.kind == "fcn":
        x = images.reshape(images.shape[0], -1)
        x = torch.sigmoid(x @ params["fc1"]["w"] + params["fc1"]["b"])
        x = torch.sigmoid(x @ params["fc2"]["w"] + params["fc2"]["b"])
        return x @ params["out"]["w"] + params["out"]["b"]
    x = torch.tanh(_conv2d(images, params["conv1"]["w"], params["conv1"]["b"]))
    x = _maxpool(x)
    x = torch.tanh(_conv2d(x, params["conv2"]["w"], params["conv2"]["b"]))
    x = _maxpool(x)
    x = x.reshape(x.shape[0], -1)  # NHWC order: fc1's rows are (h, w, c)
    x = torch.tanh(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.tanh(x @ params["fc2"]["w"] + params["fc2"]["b"])
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
    """All conv/fc weight matrices are analog (fully-analog nets, paper §4)."""
    return path.endswith("/w")
