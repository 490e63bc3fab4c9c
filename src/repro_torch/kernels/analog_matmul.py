"""Binding of the IO-quantized analog MVM kernels (``csrc/analog_mvm.cu``).

They replace the TPU kernel ``analog_mvm_pallas``
(``src/repro/kernels/analog_matmul.py``) with two launches on the current
stream: ``dac_codes_cuda``, the ABS_MAX row scale and the integer DAC codes
of x once per row, and ``mvm_codes_cuda``, the product of the codes with
``w`` on the tensor cores (an f32 ``w`` as three exact bf16 pieces) with
the output noise, ADC and rescale in its epilogue. ``analog_mvm_cuda`` runs
both. They take contiguous ``x`` (M, K) and ``w`` (K, N) in float32 or
bfloat16 and float32 standard normals ``noise`` (M, N), bounds-check
ragged shapes (no block padding), and return (M, N) in ``x``'s dtype.
``kernels.ops.analog_mvm`` is the wrapper callers use; this module only
checks operands, allocates and launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DAC_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_MVM_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                 + [ctypes.c_void_p])
_INT32_MAX = 2 ** 31 - 1
# bf16 holds every integer up to 256 exactly: the largest code it can carry
MAX_CODE = 256

_FNS = {}


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("analog_mvm"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_cuda(first, **named):
    """Every named tensor contiguous on the CUDA device of ``first``."""
    for name, t in named.items():
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{name} must be a CUDA tensor on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_io(inp_res: float, inp_bound: float) -> None:
    if inp_bound / inp_res > MAX_CODE:
        raise ValueError(
            f"inp_bound / inp_res = {inp_bound / inp_res:g} > {MAX_CODE}: the "
            f"DAC codes would not be exact in bfloat16")


def _launch(x, fn, argtypes, args, what: str) -> None:
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.device.index == torch.cuda.current_device():
        err = _fn(fn, argtypes)(*args, stream)
    else:
        with torch.cuda.device(x.device):
            err = _fn(fn, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def dac_codes_cuda(x, *, inp_res: float, inp_bound: float):
    """The DAC of x (M, K): ``(codes, s)``, the integer codes
    ``rint(clip(x / s, +-inp_bound) / inp_res)`` as bfloat16 (M, K) and the
    float32 (M, 1) ABS_MAX row scale, as ``ref.dac_codes``."""
    _check_io(inp_res, inp_bound)
    if x.ndim != 2:
        raise ValueError(f"dac_codes kernel takes x (M, K), got "
                         f"{tuple(x.shape)}")
    _check_cuda(x, x=x)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, k = x.shape
    if max(m, k) > _INT32_MAX:
        raise ValueError(f"dac_codes kernel shape out of range: "
                         f"{tuple(x.shape)}")
    codes = torch.empty((m, k), dtype=torch.bfloat16, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    # ctypes rounds the reciprocal to float32 here, on the host, as torch
    # rounds the Python scalar the plain version multiplies by
    _launch(x, "dac_codes_launch", _DAC_ARGTYPES,
            (_DTYPE_CODE[x.dtype], x.data_ptr(), codes.data_ptr(),
             s.data_ptr(), m, k, 1.0 / inp_res, inp_bound), "dac_codes")
    return codes, s


def mvm_codes_cuda(codes, s, w, noise, out_dtype, *, inp_res: float,
                   out_res: float, out_bound: float,
                   out_noise: float) -> torch.Tensor:
    """The product of the DAC ``codes`` (M, K) and row scales ``s`` (M, 1)
    from ``dac_codes_cuda`` with ``w`` (K, N) on the tensor cores, and the
    epilogue; returns (M, N) in ``out_dtype``."""
    if codes.ndim != 2 or w.ndim != 2 or codes.shape[1] != w.shape[0]:
        raise ValueError(f"analog_mvm kernel takes x (M, K) and w (K, N), got "
                         f"{tuple(codes.shape)} and {tuple(w.shape)}")
    m, k = codes.shape
    n = w.shape[1]
    _check_cuda(codes, codes=codes, w=w, s=s, noise=noise)
    if tuple(s.shape) != (m, 1) or tuple(noise.shape) != (m, n):
        raise ValueError(f"s must be ({m}, 1) and noise ({m}, {n}), got "
                         f"{tuple(s.shape)} and {tuple(noise.shape)}")
    if w.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"w and the output must be float32 or bfloat16, got "
                        f"{w.dtype}/{out_dtype}")
    for name, t, dt in (("codes", codes, torch.bfloat16),
                        ("s", s, torch.float32), ("noise", noise, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if max(m, k, n) > _INT32_MAX or -(-n // 64) > 65535:
        raise ValueError(f"analog_mvm kernel shape out of range: "
                         f"{tuple(codes.shape)} @ {tuple(w.shape)}")
    out = torch.empty((m, n), dtype=out_dtype, device=codes.device)
    _launch(codes, "analog_mvm_launch", _MVM_ARGTYPES,
            (_DTYPE_CODE[out_dtype], _DTYPE_CODE[w.dtype], codes.data_ptr(),
             w.data_ptr(), s.data_ptr(), noise.data_ptr(), out.data_ptr(),
             m, n, k, inp_res, out_res, 1.0 / out_res, out_bound,
             out_noise), "analog_mvm")
    return out


def analog_mvm_cuda(x, w, noise, *, inp_res: float, inp_bound: float,
                    out_res: float, out_bound: float,
                    out_noise: float) -> torch.Tensor:
    """Both launches on the current stream; returns (M, N) in ``x``'s
    dtype. Raises if the operands are not what the kernels take or a
    launch is refused."""
    _check_io(inp_res, inp_bound)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"analog_mvm kernel takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    _check_cuda(x, x=x, w=w, noise=noise)
    codes, s = dac_codes_cuda(x, inp_res=inp_res, inp_bound=inp_bound)
    return mvm_codes_cuda(codes, s, w, noise, x.dtype, inp_res=inp_res,
                          out_res=out_res, out_bound=out_bound,
                          out_noise=out_noise)
