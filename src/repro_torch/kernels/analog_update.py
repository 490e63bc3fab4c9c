"""Binding of the fused analog pulse-update kernel (``csrc/analog_update.cu``).

The CUDA kernel replaces the TPU kernel ``analog_update_pallas``
(``src/repro/kernels/analog_update.py``). It reads 24 bytes and writes 4
per float32 element, and issues about as many instructions as it moves
bytes at the card's rates (``csrc/analog_update.cu``). It takes
contiguous 2-D tiles or 3-D ``(k, m, n)`` tile stacks of any size (it
bounds-checks, so no block padding), ``w``/``dw`` in float32 or bfloat16,
``gamma``/``rho``/``zeta`` in float32 and ``ubits`` as a uint32 bit
pattern (int32 or uint32 tensor).
``out=w`` writes the result back into ``w`` (the kernel's in-place mode,
``repro_torch::analog_update_``). ``analog_update_hash_cuda`` is the
hash-noise mode (``repro_torch::analog_update_hash`` and its in-place
``::analog_update_hash_``): no ``ubits``/``zeta`` operands, the kernel draws
them from the fastrng hash (``csrc/fastrng.cuh``) with one ``(s0, s1)`` seed
per member of an ``(n, *member)`` stack, 20 bytes an element (16 with bf16
``w``). ``kernels.ops.analog_update`` is the wrapper the model code calls;
this module checks operands, rounds the launch scalars and launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SCALARS = ctypes.c_float * 10
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int64, _SCALARS, ctypes.c_int, ctypes.c_void_p])
_HASH_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                  + [ctypes.c_int64] * 2
                  + [_SCALARS, ctypes.c_int, ctypes.c_void_p])

# The fast division's range (csrc/analog_update.cu, div_fast/div_ok): the
# divisors it takes and the bound on |x|, inside which it is exact.
DIVISOR_RANGE = (2.0 ** -32, 2.0 ** 32)
DIV_HI = 2.0 ** 64


def launch_scalars(dw_min: float, tau_min: float, tau_max: float,
                   sigma_c2c: float, bl: int = 0) -> tuple:
    """The kernel's float32 scalars (``Scalars`` in csrc/analog_update.cu),
    rounded as torch rounds the plain version's: ``dw_min``, ``RN(1 /
    dw_min)``, ``tau_min``, ``RN(1 / tau_min)``, ``tau_max``, ``RN(1 /
    tau_max)`` (numpy float32 divisions), ``float32(dw_min * sigma_c2c)``,
    the pulse cap (``inf`` for none) and the fast division's bounds on
    ``|dw|`` and ``|w|`` (``DIV_HI``, or 0 where a divisor is outside
    ``DIVISOR_RANGE``: always the IEEE division)."""
    f32 = np.float32
    d = [f32(dw_min), f32(tau_min), f32(tau_max)]
    with np.errstate(divide="ignore", over="ignore"):
        r = [f32(1.0) / x for x in d]
    lo, hi = DIVISOR_RANGE
    ok = [bool(lo <= x <= hi) for x in d]
    return (d[0], r[0], d[1], r[1], d[2], r[2], f32(dw_min * sigma_c2c),
            f32(bl) if bl and bl > 0 else f32(np.inf),
            f32(DIV_HI if ok[0] else 0.0),
            f32(DIV_HI if ok[1] and ok[2] else 0.0))


@functools.lru_cache(maxsize=256)
def _scalars_arg(dw_min, tau_min, tau_max, sigma_c2c, bl):
    """``launch_scalars`` as the launch takes them, made once a config (a
    step launches K1 with a few configs many times)."""
    return _SCALARS(*launch_scalars(dw_min, tau_min, tau_max, sigma_c2c, bl))


def _launch_args(arrays, dw_min, tau_min, tau_max, sigma_c2c, bl,
                 vec_ok: bool):
    """(scalars, vec) of a launch: vec where every array is 16-byte aligned
    (8 for bfloat16) and ``vec_ok``."""
    vec = vec_ok and all(t.data_ptr() % (4 * t.element_size()) == 0
                         for t in arrays)
    return _scalars_arg(dw_min, tau_min, tau_max, sigma_c2c, bl), int(vec)


_FNS = {}


def _fn(name: str = "analog_update_launch"):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("analog_update"), name)
        fn.argtypes = (_HASH_ARGTYPES if name == "analog_update_hash_launch"
                       else _ARGTYPES)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_same(w, named):
    for name, t in named.items():
        if not t.is_cuda or t.device != w.device:
            raise ValueError(f"{name} must be a CUDA tensor on {w.device}")
        if t.shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"w has {tuple(w.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.dtype not in _DTYPE_CODE or named["dw"].dtype not in _DTYPE_CODE:
        raise TypeError(f"w/dw must be float32 or bfloat16, got "
                        f"{w.dtype}/{named['dw'].dtype}")
    for name in ("gamma", "rho", "zeta"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")


def _check(w, dw, gamma, rho, ubits, zeta):
    if w.ndim not in (2, 3):
        raise ValueError(f"analog_update kernel takes 2-D or 3-D tensors, "
                         f"got shape {tuple(w.shape)}")
    _check_same(w, dict(w=w, dw=dw, gamma=gamma, rho=rho, ubits=ubits,
                        zeta=zeta))
    if ubits.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"ubits must be a uint32 bit pattern (int32/uint32), "
                        f"got {ubits.dtype}")


def analog_update_cuda(w, dw, gamma, rho, ubits, zeta, *, dw_min: float,
                       tau_min: float, tau_max: float, sigma_c2c: float,
                       bl: int = 0, out=None) -> torch.Tensor:
    """Launch the kernel on the current stream; returns the new ``w``
    (``out=w``: written into ``w``, the in-place mode). Raises if the
    operands are not what the kernel takes or the launch is refused."""
    _check(w, dw, gamma, rho, ubits, zeta)
    if out is None:
        out = torch.empty_like(w)
    elif out is not w:
        raise ValueError("out must be None or w itself")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    scalars, vec = _launch_args(
        (w, dw, gamma, rho, ubits, zeta, out), dw_min, tau_min, tau_max,
        sigma_c2c, bl, True)
    args = (_DTYPE_CODE[w.dtype], _DTYPE_CODE[dw.dtype],
            w.data_ptr(), dw.data_ptr(), gamma.data_ptr(), rho.data_ptr(),
            ubits.data_ptr(), zeta.data_ptr(), out.data_ptr(), w.numel(),
            scalars, vec, stream)
    _launch(w, "analog_update_launch", args)
    return out


def _launch(w, name: str, args) -> None:
    if w.device.index == torch.cuda.current_device():
        err = _fn(name)(*args)
    else:
        with torch.cuda.device(w.device):
            err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"analog_update kernel launch failed: CUDA error "
                           f"{err}")


def analog_update_hash_cuda(w, dw, gamma, rho, seeds, *, dw_min: float,
                            tau_min: float, tau_max: float, sigma_c2c: float,
                            bl: int = 0, out=None) -> torch.Tensor:
    """K1's hash-noise mode on the current stream: ``w`` (any shape, its
    ``n * member`` elements an ``(n, *member)`` stack in memory order),
    ``seeds`` an ``(n, 2)`` int32 tensor on the card (the uint32 seed words);
    ``ubits``/``zeta`` are drawn in the kernel as ``fastrng`` draws them
    (salts 1 and 2, the linear index restarting per member). Returns the
    new ``w`` (``out=w``: written into ``w``). Raises as
    ``analog_update_cuda`` does."""
    _check_same(w, dict(w=w, dw=dw, gamma=gamma, rho=rho))
    if (not seeds.is_cuda or seeds.device != w.device
            or seeds.dtype != torch.int32 or seeds.ndim != 2
            or seeds.shape[1] != 2 or not seeds.is_contiguous()):
        raise ValueError(f"seeds must be a contiguous (n, 2) int32 tensor on "
                         f"{w.device}, got {tuple(seeds.shape)} "
                         f"{seeds.dtype} on {seeds.device}")
    n = seeds.shape[0]
    if n == 0 or w.numel() % n:
        raise ValueError(f"{w.numel()} elements are not {n} equal members")
    member = w.numel() // n
    if member >= 2 ** 31:
        raise ValueError(f"a member of {member} elements is past the "
                         f"kernel's 32-bit index")
    if out is None:
        out = torch.empty_like(w)
    elif out is not w:
        raise ValueError("out must be None or w itself")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    scalars, vec = _launch_args(
        (w, dw, gamma, rho, out), dw_min, tau_min, tau_max, sigma_c2c, bl,
        n == 1 or member % 4 == 0)
    args = (_DTYPE_CODE[w.dtype], _DTYPE_CODE[dw.dtype],
            w.data_ptr(), dw.data_ptr(), gamma.data_ptr(), rho.data_ptr(),
            seeds.data_ptr(), out.data_ptr(), n, member, scalars, vec,
            stream)
    _launch(w, "analog_update_hash_launch", args)
    return out
