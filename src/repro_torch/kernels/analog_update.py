"""Binding of the fused analog pulse-update kernel (``csrc/analog_update.cu``).

The CUDA kernel replaces the TPU kernel ``analog_update_pallas``
(``src/repro/kernels/analog_update.py``). It is memory bound: 24 bytes read
and 4 written per float32 element. It takes contiguous 2-D tiles or 3-D
``(k, m, n)`` tile stacks of any size (it bounds-checks, so no block
padding), ``w``/``dw`` in float32 or bfloat16, ``gamma``/``rho``/``zeta`` in
float32 and ``ubits`` as a uint32 bit pattern (int32 or uint32 tensor).
``kernels.ops.analog_update`` is the wrapper the model code calls; this
module only checks operands and launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int64] + [ctypes.c_float] * 5 + [ctypes.c_void_p])


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("analog_update").analog_update_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(w, dw, gamma, rho, ubits, zeta):
    if w.ndim not in (2, 3):
        raise ValueError(f"analog_update kernel takes 2-D or 3-D tensors, "
                         f"got shape {tuple(w.shape)}")
    named = dict(w=w, dw=dw, gamma=gamma, rho=rho, ubits=ubits, zeta=zeta)
    for name, t in named.items():
        if not t.is_cuda or t.device != w.device:
            raise ValueError(f"{name} must be a CUDA tensor on {w.device}")
        if t.shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"w has {tuple(w.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.dtype not in _DTYPE_CODE or dw.dtype not in _DTYPE_CODE:
        raise TypeError(f"w/dw must be float32 or bfloat16, got "
                        f"{w.dtype}/{dw.dtype}")
    for name in ("gamma", "rho", "zeta"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")
    if ubits.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"ubits must be a uint32 bit pattern (int32/uint32), "
                        f"got {ubits.dtype}")


def analog_update_cuda(w, dw, gamma, rho, ubits, zeta, *, dw_min: float,
                       tau_min: float, tau_max: float, sigma_c2c: float,
                       bl: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream; returns the new ``w``.
    Raises if the operands are not what the kernel takes or the launch is
    refused."""
    _check(w, dw, gamma, rho, ubits, zeta)
    out = torch.empty_like(w)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    args = (_DTYPE_CODE[w.dtype], _DTYPE_CODE[dw.dtype],
            w.data_ptr(), dw.data_ptr(), gamma.data_ptr(), rho.data_ptr(),
            ubits.data_ptr(), zeta.data_ptr(), out.data_ptr(), w.numel(),
            dw_min, tau_min, tau_max, dw_min * sigma_c2c,
            float(bl) if bl and bl > 0 else 0.0, stream)
    if w.device.index == torch.cuda.current_device():
        err = _fn()(*args)
    else:
        with torch.cuda.device(w.device):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"analog_update kernel launch failed: CUDA error "
                           f"{err}")
    return out
