"""Stateless per-element hash RNG for analog-update noise.

A murmur3-style integer hash of (linear index, seed, salt), bit-identical
to the JAX package's ``kernels/fastrng.py``: the same uint32 bits, and
normals through the same inverse CDF (bitcast fast log + Giles' erfinv
polynomials). The plain versions (``hash_bits``, ``hash_uniform``,
``hash_normal_ref``) run uint32 math in int64 with ``& 0xFFFFFFFF`` masks.

``seed`` is a ``(2,)`` int64 tensor of uint32 words, or a ``(n, 2)`` batch
of them: a batch draws ``(n, *shape)``, row i being exactly the draw for
seed i alone (the linear index restarts per row). ``device_seeds`` gives
the same words as int32 on a device, the form the kernels take; every
function here takes either.

``hash_normal`` is the custom op ``repro_torch::hash_normal``
(``kernels/ops.py``): on the card one pass of the hand-written kernel
``csrc/fastrng.cu`` (``hash_normal_cuda`` below), bit-equal to the plain
chain there; on the CPU the plain chain; on ``meta`` the fake rule. The
device is the ``device`` argument's. It replaces no Pallas kernel: the JAX
module is jnp that XLA fuses into its consumer, which eager torch cannot
do. K1's hash-noise mode (``repro_torch::analog_update_hash``) draws the
update's noise inside the update kernel from the same device code
(``csrc/fastrng.cuh``). So no step on the card calls ``hash_bits`` or
``hash_uniform``, which stay plain: the operand mode of K1 (``noise=``),
the CPU and the lifetime model's GDC reference use them.

``hash_device_cuda`` binds the same file's device draw, the op
``repro_torch::hash_device`` (``kernels/ops.py``) that
``core/device.py``'s ``sample_device(method="hash")`` calls: a tile's
``(gamma, rho)`` in one pass from the normals of salts 11, 13 and 17,
bit-equal to its plain version ``hash_device_ref``.

``hash_normal`` agrees with JAX to a few ULP, not bit for bit: XLA-CPU's
``sqrt`` on the tail branch differs from torch's by one ULP on some inputs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..prng import MASK, mul32
from . import cuda_build, ref

_SQRT2 = 1.4142135623730951
# f32 just below 1: keeps erfinv off its +/-1 poles (see the JAX module)
_ONE_MINUS_EPS = 0.99999994
_LN2 = 0.6931471805599453
_ERFINV_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164,
                   0.246640727, 1.50140941)
_ERFINV_TAIL = (0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047,
                1.00167406, 2.83297682)


def _finalize(x):
    """murmur3 fmix32 finalizer on int64-held uint32."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _seed_words(seed, ndim: int, device):
    """Seed words as ints, or as ``(n, 1, ..., 1)`` tensors for a batch
    (int32 words, ``device_seeds``' form, taken as uint32)."""
    seed = torch.as_tensor(seed)
    seed = (seed.to(torch.int64) & MASK if seed.dtype == torch.int32
            else seed.to(torch.int64))
    if seed.ndim == 1:
        return int(seed[0]), int(seed[1])
    s = seed.to(device).reshape(seed.shape[0], 2, *([1] * ndim))
    return s[:, 0], s[:, 1]


def device_seeds(seed, device) -> torch.Tensor:
    """The uint32 seed words of ``seed`` (``(2,)`` or ``(n, 2)``, host
    int64) as int32 bit patterns of the same shape on ``device``, the form
    the kernels take: one upload, made from pinned memory without a sync on
    the card. An int32 seed is taken to be such words already and passes
    as it is."""
    seed = torch.as_tensor(seed)
    if seed.dtype == torch.int32:
        return seed
    s = seed.to(torch.int64) & MASK
    s = (s - ((s >> 31) << 32)).to(torch.int32)
    device = torch.device(device)
    if device.type == "cuda":
        return s.pin_memory().to(device, non_blocking=True)
    return s.to(device)


def hash_bits(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """uint32 hash bits of ``shape`` (int64 in [0, 2**32))."""
    shape = tuple(int(d) for d in shape)
    s0, s1 = _seed_words(seed, len(shape), device)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape) & MASK
    x = (mul32(idx, 0xCC9E2D51) + s0 + ((salt * 0x9E3779B9) & MASK)) & MASK
    x = _finalize(x)
    x = x ^ ((s1 + (salt & MASK)) & MASK)
    return _finalize(x)


def hash_uniform(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """[0, 1) float32."""
    return hash_bits(seed, shape, salt, device).to(torch.float32) * (
        1.0 / 4294967296.0)


def _fast_neg_log(y: torch.Tensor) -> torch.Tensor:
    """-log(y) for float32 y in (0, 1] by an exponent/mantissa bitcast split.
    The last term divides tensor by tensor: ``float / tensor`` in torch is a
    multiply by the reciprocal, which rounds differently."""
    bi = y.view(torch.int32)
    mant = ((bi & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    num = torch.full_like(mant, 1.72587999)
    log2y = (bi.to(torch.float32) * 1.1920928955078125e-07
             - 124.22551499 - 1.498030302 * mant
             - num / (0.3520887068 + mant))
    return -_LN2 * log2y


def hash_normal_ref(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """Standard normal by the inverse CDF of one hashed uniform: the plain
    version of ``hash_normal``, eager, one int64 temporary a step."""
    u = (hash_bits(seed, shape, salt, device).to(torch.float32) + 0.5) * (
        1.0 / 4294967296.0)
    x = torch.clamp(2.0 * u - 1.0, -_ONE_MINUS_EPS, _ONE_MINUS_EPS)
    w = _fast_neg_log(1.0 - x * x)
    wc = w - 2.5
    p1 = torch.full_like(w, 2.81022636e-08)
    for c in _ERFINV_CENTRAL:
        p1 = p1 * wc + c
    ws = torch.sqrt(torch.clamp_min(w, 5.0)) - 3.0
    p2 = torch.full_like(w, -0.000200214257)
    for c in _ERFINV_TAIL:
        p2 = p2 * ws + c
    return _SQRT2 * torch.where(w < 5.0, p1, p2) * x


def member_draw(fn, seeds, shape, salt: int, device):
    """``fn``'s plain draw at ``shape`` from ``(n, 2)`` seeds, the n members
    of ``shape`` in memory order (n = 1: ``shape`` whole)."""
    n = seeds.shape[0]
    if n == 1:
        return fn(seeds[0], shape, salt, device)
    return fn(seeds, (math.prod(shape) // n,), salt, device).reshape(shape)


# the salts of the three normals a device draw may read: the slope
# (gamma), the asymmetry (rho) and the target SP
DEVICE_SALTS = (11, 13, 17)


def hash_device_ref(seeds, shape, device, **scalars):
    """The plain version of ``repro_torch::hash_device``: float32 ``(gamma,
    rho)`` of ``shape`` on ``device`` from ``(n, 2)`` seed words (the n
    members of ``shape``; n = 1: ``shape`` whole) for the ``DeviceConfig``
    scalars given (``ref.DEVICE_FIELDS``), the eager chain drawing only the
    normals they read (``hash_normal_ref``)."""
    seeds = torch.as_tensor(seeds).reshape(-1, 2)

    def normal(i):
        return member_draw(hash_normal_ref, seeds, shape, DEVICE_SALTS[i],
                           device)

    return ref.device_params_ref(normal, shape, device, **scalars)


def hash_normal(seed, shape, salt: int, device="cuda") -> torch.Tensor:
    """Standard normal by the inverse CDF of one hashed uniform, float32 of
    ``shape`` (``(n, *shape)`` for an ``(n, 2)`` seed): the op
    ``repro_torch::hash_normal`` on ``device``."""
    from . import ops  # ops imports this module

    shape = tuple(int(d) for d in shape)
    seeds = device_seeds(seed, device)
    if seeds.ndim == 2:
        shape = (seeds.shape[0],) + shape
    return ops.hash_normal_op(seeds.reshape(-1, 2), list(shape), int(salt))


_HASH_NORMAL = None


def hash_normal_cuda(seeds, out, salt: int) -> torch.Tensor:
    """Launch ``csrc/fastrng.cu`` on the current stream: ``out`` (float32,
    contiguous, ``n * member`` elements) gets the draws of the ``(n, 2)``
    int32 ``seeds`` on the card. Raises on operands the kernel does not
    take or a refused launch."""
    global _HASH_NORMAL
    if (not seeds.is_cuda or seeds.dtype != torch.int32 or seeds.ndim != 2
            or seeds.shape[1] != 2 or not seeds.is_contiguous()):
        raise ValueError(f"seeds must be a contiguous (n, 2) int32 CUDA "
                         f"tensor, got {tuple(seeds.shape)} {seeds.dtype} on "
                         f"{seeds.device}")
    if (not out.is_cuda or out.device != seeds.device
            or out.dtype != torch.float32 or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 tensor on "
                         f"{seeds.device}")
    n = seeds.shape[0]
    if n == 0 or out.numel() % n:
        raise ValueError(f"{out.numel()} draws are not {n} equal members")
    member = out.numel() // n
    if member >= 2 ** 31:
        raise ValueError(f"a member of {member} elements is past the "
                         f"kernel's 32-bit index")
    if _HASH_NORMAL is None:
        fn = cuda_build.load("fastrng").hash_normal_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_uint32, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _HASH_NORMAL = fn
    # 16-byte stores where every member starts 16-byte aligned
    vec = out.data_ptr() % 16 == 0 and (n == 1 or member % 4 == 0)
    with torch.cuda.device(out.device):
        err = _HASH_NORMAL(seeds.data_ptr(), out.data_ptr(), n, member,
                           int(salt) & MASK, int(vec),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_normal kernel launch failed: CUDA error "
                           f"{err}")
    return out


_HASH_DEVICE = None


def hash_device_cuda(seeds, gamma, rho, *, sigma_d2d: float,
                     sigma_pm: float, ref_mean: float, ref_std: float,
                     tau_min: float, tau_max: float) -> None:
    """Launch ``csrc/fastrng.cu``'s ``hash_device`` on the current stream:
    ``gamma`` and ``rho`` (float32, contiguous, ``n * member`` elements
    each) get the device parameters of the ``(n, 2)`` int32 ``seeds`` on
    the card, for the ``DeviceConfig`` scalars given. Raises on operands
    the kernel does not take or a refused launch."""
    global _HASH_DEVICE
    if (not seeds.is_cuda or seeds.dtype != torch.int32 or seeds.ndim != 2
            or seeds.shape[1] != 2 or not seeds.is_contiguous()):
        raise ValueError(f"seeds must be a contiguous (n, 2) int32 CUDA "
                         f"tensor, got {tuple(seeds.shape)} {seeds.dtype} on "
                         f"{seeds.device}")
    for t in (gamma, rho):
        if (not t.is_cuda or t.device != seeds.device
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16 or t.numel() != gamma.numel()):
            raise ValueError(f"gamma and rho must be contiguous float32 "
                             f"tensors of one size on {seeds.device}, "
                             f"16-byte aligned")
    n = seeds.shape[0]
    if n == 0 or gamma.numel() % n:
        raise ValueError(f"{gamma.numel()} elements are not {n} equal "
                         f"members")
    member = gamma.numel() // n
    if member >= 2 ** 31:
        raise ValueError(f"a member of {member} elements is past the "
                         f"kernel's 32-bit index")
    if _HASH_DEVICE is None:
        fn = cuda_build.load("fastrng").hash_device_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                       + [ctypes.c_double] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _HASH_DEVICE = fn
    with torch.cuda.device(gamma.device):
        err = _HASH_DEVICE(seeds.data_ptr(), gamma.data_ptr(),
                           rho.data_ptr(), n, member, float(sigma_d2d),
                           float(sigma_pm), float(ref_mean), float(ref_std),
                           float(tau_min), float(tau_max),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_device kernel launch failed: CUDA error "
                           f"{err}")


def seed_from_key(key) -> torch.Tensor:
    """PRNG key -> uint32 seed words (the raw key data); a ``(n, 2)`` batch
    of keys gives a batch of seeds."""
    return torch.as_tensor(key).to(torch.int64)[..., :2]
