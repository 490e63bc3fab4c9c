"""Gradient compression for the data-parallel all-reduce.

Port of the JAX package's ``distributed/compression.py``: an int8
block-quantized all-reduce with error feedback. Each worker quantizes its
gradient to int8 with a per-block float32 scale shared by all workers (a
MAX all-reduce of the per-block scales), the int8 payload is summed in
int32 (a SUM all-reduce), dequantized and divided by the worker count, and
what quantization dropped from this worker's share is kept as an
error-feedback residual for the next step's gradient (Karimireddy et al.
2019). The operations run in the reference's order, so the result is
bit-equal to it on the same inputs: ``torch.round`` rounds half to even as
``jnp.round`` does, and divisions are tensor by tensor (``kernels.ref.div``).
"""
from __future__ import annotations

import torch

from ..kernels.ref import div
from . import runtime

BLOCK = 256


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % block
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)


def _scale(blk: torch.Tensor) -> torch.Tensor:
    """Per-block max |x| / 127, floored at 1e-12."""
    return torch.clamp_min(div(torch.amax(torch.abs(blk), dim=1), 127.0),
                           1e-12)


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """x: (N,) float32 -> (q int8 (N + pad,), scales float32 (nblk,), N)."""
    n = x.shape[0]
    xp = _blocks(x, block)
    scale = _scale(xp)[:, None]
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0], n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                    block: int = BLOCK) -> torch.Tensor:
    xq = q.reshape(-1, block).to(torch.float32) * scale[:, None]
    return xq.reshape(-1)[:n]


def compressed_psum_mean(x: torch.Tensor, group):
    """int8 all-reduce-mean of ``x`` over ``group`` (a process group; None
    is a group of one). Returns (mean in ``x``'s dtype, this worker's
    error-feedback residual in float32). Collective."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    blk = _blocks(flat, BLOCK)
    gmax = runtime.all_reduce(_scale(blk), group, op="max")       # (nblk,)
    q = torch.clamp(torch.round(blk / gmax[:, None]), -127, 127).to(torch.int8)
    qsum = runtime.all_reduce(q.to(torch.int32), group, op="sum")
    nworkers = torch.full((), runtime.world_of(group), dtype=torch.float32,
                          device=x.device)
    mean = qsum.to(torch.float32) * gmax[:, None] / nworkers
    out = mean.reshape(-1)[:n]
    err = flat - (q.to(torch.float32) * gmax[:, None]).reshape(-1)[:n]
    return out.reshape(x.shape).to(x.dtype), err.reshape(x.shape)


def make_compressed_grad_fn(mesh, axis_name: str = "data"):
    """``f(local_grad, err_buf) -> (mean_grad, new_err_buf)``: the int8
    all-reduce over the mesh axis ``axis_name``, each rank passing its own
    block (the reference's ``shard_map`` with ``P(axis_name)`` in and out)
    and the residual added to the gradient first."""

    def apply(local_grad, err_buf):
        return compressed_psum_mean(local_grad + err_buf,
                                    mesh.group(axis_name))

    return apply
