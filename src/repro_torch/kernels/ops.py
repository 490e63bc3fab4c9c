"""Dispatching wrappers around the port's kernels.

A wrapper runs its hand-written CUDA kernel on CUDA tensors and its plain
PyTorch version (``kernels/ref.py``) on CPU tensors, and decides by the
device of the tensor it is given, and nothing else: on a CUDA tensor a
wrapper launches its kernel or raises, it never falls back.

``LAUNCHES`` counts, per kernel, the launches these wrappers made, so a
run can show that its main path went through the kernels.

The CUDA kernels bounds-check ragged shapes, so the Pallas block padding of
the JAX package's ``ops.py`` has no counterpart here. Noise is always drawn
at the original shape, so both backends consume identical random bits.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import prng
from . import fastrng, ref

LAUNCHES: Dict[str, int] = {"analog_update": 0, "analog_mvm": 0,
                            "sp_filter": 0}


def backend(x: torch.Tensor) -> str:
    """The backend a wrapper uses for tensor ``x``: its kernel on a CUDA
    tensor, the plain version (``kernels/ref.py``) on a CPU tensor."""
    return "cuda" if x.is_cuda else "ref"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _view2d(x: torch.Tensor) -> torch.Tensor:
    """View any rank as 2-D (leading dims flattened); 3-D stays 3-D."""
    if x.ndim in (2, 3):
        return x
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        return x.reshape(1, -1)
    return x.reshape(-1, x.shape[-1])


# ---------------------------------------------------------------------------
# analog pulse update
# ---------------------------------------------------------------------------


def make_noise(key, shape, device, rng: str = "threefry"):
    """(ubits, zeta) at ``shape``: threefry (``jax.random`` bits) or the
    fastrng hash (salts 1/2), as the JAX package draws them."""
    if rng == "hash":
        seed = fastrng.seed_from_key(key)
        return (fastrng.hash_bits(seed, shape, 1, device),
                fastrng.hash_normal(seed, shape, 2, device))
    ku, kz = prng.split(key)
    return prng.bits(ku, shape, device), prng.normal(kz, shape, device)


def analog_update(w, dw, gamma, rho, key, *, dw_min: float, tau_min: float,
                  tau_max: float, sigma_c2c: float, bl: int = 0,
                  rng: str = "threefry", noise=None):
    """Fused analog pulse update; see ``ref.analog_update_ref``.

    ``noise`` optionally supplies pre-drawn ``(ubits, zeta)`` at
    ``w.shape``; then ``key``/``rng`` are ignored and may be None.
    """
    kw = dict(dw_min=dw_min, tau_min=tau_min, tau_max=tau_max,
              sigma_c2c=sigma_c2c, bl=bl)
    ubits, zeta = (noise if noise is not None
                   else make_noise(key, w.shape, w.device, rng))
    if backend(w) == "ref":
        return ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta, **kw)

    from .analog_update import analog_update_cuda

    if ubits.dtype == torch.int64:
        ubits = ubits.to(torch.int32)  # same low 32 bits: the u32 pattern
    f32 = torch.float32
    operands = [_view2d(t).contiguous() for t in (
        w, dw, gamma.to(f32), rho.to(f32), ubits, zeta.to(f32))]
    out = analog_update_cuda(*operands, **kw)
    LAUNCHES["analog_update"] += 1
    return out.reshape(w.shape)


# ---------------------------------------------------------------------------
# analog MVM
# ---------------------------------------------------------------------------


def analog_mvm(x, w, key, *, inp_res: float, inp_bound: float,
               out_res: float, out_bound: float, out_noise: float,
               noise=None):
    """IO-quantized crossbar forward: ``x`` (..., K) @ ``w`` (K, N) ->
    (..., N) in ``x``'s dtype; see ``ref.analog_mvm_ref``.

    The output noise is ``prng.normal(key, (M, N))`` at the flattened
    output shape, as the JAX package draws it, unless ``noise`` (any shape
    of M * N elements) is given; then ``key`` is ignored and may be None.
    """
    io = dict(inp_res=inp_res, inp_bound=inp_bound, out_res=out_res,
              out_bound=out_bound, out_noise=out_noise)
    batch_shape = x.shape[:-1]
    n = w.shape[-1]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    noise = (prng.normal(key, (m, n), x.device) if noise is None
             else noise.reshape(m, n))
    if backend(x) == "ref":
        out = ref.analog_mvm_ref(x2, w, noise, **io)
    else:
        from .analog_matmul import analog_mvm_cuda

        out = analog_mvm_cuda(x2.contiguous(), w.contiguous(),
                              ref.abs_max_scale(x2),
                              noise.to(torch.float32).contiguous(), **io)
        LAUNCHES["analog_mvm"] += 1
    return out.reshape(*batch_shape, n)


# ---------------------------------------------------------------------------
# SP filter
# ---------------------------------------------------------------------------


def sp_filter(q, p, gamma, rho, *, eta: float, tau_min: float,
              tau_max: float):
    """EMA tracking update (12) plus telemetry, any rank: returns
    ``(q_new, gp_sq, err_sq)``, the sums as 0-d float32 tensors on ``q``'s
    device (no host sync); see ``ref.sp_filter_ref``."""
    kw = dict(eta=eta, tau_min=tau_min, tau_max=tau_max)
    if backend(q) == "ref":
        return ref.sp_filter_ref(q, p, gamma, rho, **kw)

    from .sp_filter import sp_filter_cuda

    f32 = torch.float32
    q_new, gp_sq, err_sq = sp_filter_cuda(
        q.contiguous(), p.contiguous(), gamma.to(f32).contiguous(),
        rho.to(f32).contiguous(), **kw)
    LAUNCHES["sp_filter"] += 1
    return q_new, gp_sq, err_sq
