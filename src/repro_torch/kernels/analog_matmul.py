"""Binding of the IO-quantized analog MVM kernel (``csrc/analog_mvm.cu``).

The CUDA kernel replaces the TPU kernel ``analog_mvm_pallas``
(``src/repro/kernels/analog_matmul.py``): a tiled float32 GEMM on the CUDA
cores with the input DAC fused into its prologue and the output noise, ADC
and rescale into its epilogue. It takes contiguous ``x`` (M, K) and ``w``
(K, N) in float32 or bfloat16, the (M, 1) float32 ABS_MAX row scale ``s``
and float32 standard normals ``noise`` (M, N), bounds-checks ragged shapes
(no block padding), and returns (M, N) in ``x``'s dtype.
``kernels.ops.analog_mvm`` is the wrapper callers use; this module only
checks operands and launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 7 + [ctypes.c_void_p])
_INT32_MAX = 2 ** 31 - 1

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("analog_mvm").analog_mvm_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x, w, s, noise):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"analog_mvm kernel takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, n = x.shape[0], w.shape[1]
    named = dict(x=x, w=w, s=s, noise=noise)
    for name, t in named.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(s.shape) != (m, 1) or tuple(noise.shape) != (m, n):
        raise ValueError(f"s must be ({m}, 1) and noise ({m}, {n}), got "
                         f"{tuple(s.shape)} and {tuple(noise.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"x/w must be float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    for name in ("s", "noise"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")
    if max(x.shape[0], x.shape[1], w.shape[1]) > _INT32_MAX \
            or -(-n // 32) > 65535:
        raise ValueError(f"analog_mvm kernel shape out of range: "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")


def analog_mvm_cuda(x, w, s, noise, *, inp_res: float, inp_bound: float,
                    out_res: float, out_bound: float,
                    out_noise: float) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (M, N) in ``x``'s
    dtype. Raises if the operands are not what the kernel takes or the
    launch is refused."""
    _check(x, w, s, noise)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # ctypes rounds the reciprocals to float32 here, on the host, as torch
    # rounds the Python scalars the plain version multiplies by
    args = (_DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x.data_ptr(),
            w.data_ptr(), s.data_ptr(), noise.data_ptr(), out.data_ptr(),
            m, n, k, inp_res, 1.0 / inp_res, inp_bound, out_res, 1.0 / out_res,
            out_bound, out_noise, stream)
    if x.device.index == torch.cuda.current_device():
        err = _fn()(*args)
    else:
        with torch.cuda.device(x.device):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"analog_mvm kernel launch failed: CUDA error {err}")
    return out
