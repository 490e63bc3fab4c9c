"""Binding of the SP-tracking filter kernel (``csrc/sp_filter.cu``).

The CUDA kernel replaces the TPU kernel ``sp_filter_pallas``
(``src/repro/kernels/sp_filter.py``): one fused element-wise pass that
writes ``q_new`` and reduces each block's two telemetry sums to a partial
pair, then one block that adds the partials in a fixed order (no float
atomics: the sums are bit-identical from run to run). It takes contiguous
``q``, ``p`` (float32 or bfloat16) and float32 ``gamma``, ``rho`` of one
shape, any rank. ``kernels.ops.sp_filter`` is the wrapper callers use; this
module only checks operands and launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int64, ctypes.c_int] + [ctypes.c_float] * 4
             + [ctypes.c_void_p])
THREADS = 256           # threads per block, as in the source
MAX_BLOCKS = 132 * 8    # pass 1's grid: grid-stride beyond 8 blocks per SM

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("sp_filter").sp_filter_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def blocks_for(size: int) -> int:
    """Pass 1's grid for ``size`` elements: a function of the size alone,
    so a given shape always sums in the same order."""
    return max(1, min(-(-size // THREADS), MAX_BLOCKS))


def _check(q, p, gamma, rho):
    named = dict(q=q, p=p, gamma=gamma, rho=rho)
    for name, t in named.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"q has {tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE or p.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/p must be float32 or bfloat16, got "
                        f"{q.dtype}/{p.dtype}")
    for name in ("gamma", "rho"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")


def sp_filter_cuda(q, p, gamma, rho, *, eta: float, tau_min: float,
                   tau_max: float):
    """Launch both passes on the current stream; returns ``(q_new, gp_sq,
    err_sq)``, the sums as 0-d float32 tensors on the card (no host sync).
    Raises if the operands are not what the kernel takes or a launch is
    refused."""
    _check(q, p, gamma, rho)
    size = q.numel()
    blocks = blocks_for(size)
    q_new = torch.empty_like(q)
    partials = torch.empty(2 * blocks, dtype=torch.float32, device=q.device)
    sums = torch.empty(2, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_DTYPE_CODE[q.dtype], _DTYPE_CODE[p.dtype], q.data_ptr(),
            p.data_ptr(), gamma.data_ptr(), rho.data_ptr(), q_new.data_ptr(),
            partials.data_ptr(), sums.data_ptr(), size, blocks, eta,
            1.0 - eta, tau_min, tau_max, stream)
    if q.device.index == torch.cuda.current_device():
        err = _fn()(*args)
    else:
        with torch.cuda.device(q.device):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"sp_filter kernel launch failed: CUDA error {err}")
    return q_new, sums[0], sums[1]
