"""Dispatching wrappers around the port's kernels.

Each kernel is one ``torch.library.custom_op`` in the ``repro_torch``
namespace (``repro_torch::analog_update``, ``::analog_mvm``,
``::sp_filter``; K1's in-place mode is ``::analog_update_``, which writes
``w`` and returns nothing; K1's hash-noise mode, which draws its noise in
the kernel, is ``::analog_update_hash`` and in place
``::analog_update_hash_``; ``::hash_normal`` is the one-pass normal draw of
``csrc/fastrng.cu`` and ``::hash_device`` its one-pass device draw), so
the dispatcher routes a call by the device of its tensors, and nothing
else: the CUDA implementation launches the hand-written kernel or raises,
it never falls back; the CPU implementation is the plain PyTorch version
(``kernels/ref.py``, the eager ``fastrng`` draws for the hash ops and
``fastrng.hash_device_ref`` for the device draw); the fake
rule (``meta`` tensors, fake tensors) only gives the outputs' shapes and
dtypes. A stream of dispatched operations (``roofline.op_cost.OpTrace``)
shows each kernel call as one operation under the kernel's name.

``LAUNCHES`` counts, per kernel, the calls the CUDA implementations made
to it, so a run can show that its main path went through the kernels. One
``analog_mvm`` call is two CUDA launches (the DAC prologue and the
product) and counts once. ``analog_update`` counts every K1 launch, in
any mode; ``analog_update_`` the in-place ones among them and
``analog_update_hash`` the hash-noise ones; ``hash_normal`` and
``hash_device`` the launches of ``csrc/fastrng.cu``'s two kernels.

On any device but the CPU a wrapper hands the op the operands the kernel
takes (contiguous; in K1's operand mode 2-D or 3-D with ``ubits`` as
int32; the hash ops' seeds as ``(n, 2)`` int32 words on the device), so a
``meta`` run dispatches what the card would.

The CUDA kernels bounds-check ragged shapes, so the Pallas block padding of
the JAX package's ``ops.py`` has no counterpart here. Noise is always drawn
at the original shape, so both backends consume identical random bits.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import Tensor

from .. import prng
from . import fastrng, ref

LAUNCHES: Dict[str, int] = {"analog_update": 0, "analog_update_": 0,
                            "analog_update_hash": 0, "hash_normal": 0,
                            "hash_device": 0, "analog_mvm": 0,
                            "sp_filter": 0}


def backend(x: torch.Tensor) -> str:
    """The backend a wrapper uses for tensor ``x``: its kernel on a CUDA
    tensor, the plain version (``kernels/ref.py``) on a CPU tensor; a
    ``meta`` tensor takes the kernel's operands and the fake rule."""
    return "ref" if x.device.type == "cpu" else "cuda"


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
    fastrng hash (salts 1/2), as the JAX package draws them: the operands of
    K1's operand mode, which its hash-noise mode draws in the kernel."""
    if rng == "hash":
        seed = fastrng.seed_from_key(key)
        return (fastrng.hash_bits(seed, shape, 1, device),
                fastrng.hash_normal(seed, shape, 2, device))
    ku, kz = prng.split(key)
    return prng.bits(ku, shape, device), prng.normal(kz, shape, device)


@torch.library.custom_op("repro_torch::analog_update", mutates_args=(),
                         device_types="cpu")
def _analog_update_op(w: Tensor, dw: Tensor, gamma: Tensor, rho: Tensor,
                      ubits: Tensor, zeta: Tensor, dw_min: float,
                      tau_min: float, tau_max: float, sigma_c2c: float,
                      bl: int) -> Tensor:
    return ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta,
                                 dw_min=dw_min, tau_min=tau_min,
                                 tau_max=tau_max, sigma_c2c=sigma_c2c, bl=bl)


@_analog_update_op.register_kernel("cuda")
def _(w, dw, gamma, rho, ubits, zeta, dw_min, tau_min, tau_max, sigma_c2c,
      bl):
    from .analog_update import analog_update_cuda

    out = analog_update_cuda(w, dw, gamma, rho, ubits, zeta, dw_min=dw_min,
                             tau_min=tau_min, tau_max=tau_max,
                             sigma_c2c=sigma_c2c, bl=bl)
    LAUNCHES["analog_update"] += 1
    return out


@_analog_update_op.register_fake
def _(w, dw, gamma, rho, ubits, zeta, dw_min, tau_min, tau_max, sigma_c2c,
      bl):
    return torch.empty_like(w)


@torch.library.custom_op("repro_torch::analog_update_", mutates_args=("w",),
                         device_types="cpu")
def _analog_update_inplace_op(w: Tensor, dw: Tensor, gamma: Tensor,
                              rho: Tensor, ubits: Tensor, zeta: Tensor,
                              dw_min: float, tau_min: float, tau_max: float,
                              sigma_c2c: float, bl: int) -> None:
    w.copy_(ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta,
                                  dw_min=dw_min, tau_min=tau_min,
                                  tau_max=tau_max, sigma_c2c=sigma_c2c,
                                  bl=bl))


@_analog_update_inplace_op.register_kernel("cuda")
def _(w, dw, gamma, rho, ubits, zeta, dw_min, tau_min, tau_max, sigma_c2c,
      bl):
    from .analog_update import analog_update_cuda

    analog_update_cuda(w, dw, gamma, rho, ubits, zeta, dw_min=dw_min,
                       tau_min=tau_min, tau_max=tau_max, sigma_c2c=sigma_c2c,
                       bl=bl, out=w)
    LAUNCHES["analog_update"] += 1
    LAUNCHES["analog_update_"] += 1


@_analog_update_inplace_op.register_fake
def _(w, dw, gamma, rho, ubits, zeta, dw_min, tau_min, tau_max, sigma_c2c,
      bl):
    return None


def _hash_update_ref(w, dw, gamma, rho, seeds, **kw):
    """The plain hash-noise update: the eager ``fastrng`` draws of the
    ``(n, 2)`` seeds (salts 1 and 2, per member) into ``analog_update_ref``."""
    ubits = fastrng.member_draw(fastrng.hash_bits, seeds, w.shape, 1,
                                w.device)
    zeta = fastrng.member_draw(fastrng.hash_normal_ref, seeds, w.shape, 2,
                               w.device)
    return ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta, **kw)


@torch.library.custom_op("repro_torch::analog_update_hash", mutates_args=(),
                         device_types="cpu")
def _analog_update_hash_op(w: Tensor, dw: Tensor, gamma: Tensor, rho: Tensor,
                           seeds: Tensor, dw_min: float, tau_min: float,
                           tau_max: float, sigma_c2c: float,
                           bl: int) -> Tensor:
    return _hash_update_ref(w, dw, gamma, rho, seeds, dw_min=dw_min,
                            tau_min=tau_min, tau_max=tau_max,
                            sigma_c2c=sigma_c2c, bl=bl)


@_analog_update_hash_op.register_kernel("cuda")
def _(w, dw, gamma, rho, seeds, dw_min, tau_min, tau_max, sigma_c2c, bl):
    from .analog_update import analog_update_hash_cuda

    out = analog_update_hash_cuda(w, dw, gamma, rho, seeds, dw_min=dw_min,
                                  tau_min=tau_min, tau_max=tau_max,
                                  sigma_c2c=sigma_c2c, bl=bl)
    LAUNCHES["analog_update"] += 1
    LAUNCHES["analog_update_hash"] += 1
    return out


@_analog_update_hash_op.register_fake
def _(w, dw, gamma, rho, seeds, dw_min, tau_min, tau_max, sigma_c2c, bl):
    return torch.empty_like(w)


@torch.library.custom_op("repro_torch::analog_update_hash_",
                         mutates_args=("w",), device_types="cpu")
def _analog_update_hash_inplace_op(w: Tensor, dw: Tensor, gamma: Tensor,
                                   rho: Tensor, seeds: Tensor, dw_min: float,
                                   tau_min: float, tau_max: float,
                                   sigma_c2c: float, bl: int) -> None:
    w.copy_(_hash_update_ref(w, dw, gamma, rho, seeds, dw_min=dw_min,
                             tau_min=tau_min, tau_max=tau_max,
                             sigma_c2c=sigma_c2c, bl=bl))


@_analog_update_hash_inplace_op.register_kernel("cuda")
def _(w, dw, gamma, rho, seeds, dw_min, tau_min, tau_max, sigma_c2c, bl):
    from .analog_update import analog_update_hash_cuda

    analog_update_hash_cuda(w, dw, gamma, rho, seeds, dw_min=dw_min,
                            tau_min=tau_min, tau_max=tau_max,
                            sigma_c2c=sigma_c2c, bl=bl, out=w)
    LAUNCHES["analog_update"] += 1
    LAUNCHES["analog_update_"] += 1
    LAUNCHES["analog_update_hash"] += 1


@_analog_update_hash_inplace_op.register_fake
def _(w, dw, gamma, rho, seeds, dw_min, tau_min, tau_max, sigma_c2c, bl):
    return None


def analog_update(w, dw, gamma, rho, key, *, dw_min: float, tau_min: float,
                  tau_max: float, sigma_c2c: float, bl: int = 0,
                  rng: str = "threefry", noise=None, out=None):
    """Fused analog pulse update; see ``ref.analog_update_ref``.

    ``noise`` optionally supplies pre-drawn ``(ubits, zeta)`` at
    ``w.shape`` (the operand mode); then ``key``/``rng`` are ignored and may
    be None. Without it, ``rng="hash"`` takes K1's hash-noise mode: a
    ``(2,)`` key seeds ``w`` whole, an ``(n, 2)`` batch of keys the n
    members of an ``(n, *member)`` stack, each drawn as for that member
    alone; the noise is drawn in the kernel, bit-equal to the operand mode
    fed ``make_noise``. ``out=w`` writes the result into ``w``
    (``repro_torch::analog_update_``, ``::analog_update_hash_``), bit-equal
    to the new tensor the call returns without it, and returns ``w``,
    which must then be contiguous: a copy would take the write.
    """
    kw = dict(dw_min=float(dw_min), tau_min=float(tau_min),
              tau_max=float(tau_max), sigma_c2c=float(sigma_c2c),
              bl=int(bl) if bl and bl > 0 else 0)
    if out is not None and out is not w:
        raise ValueError("out must be None or w itself")
    if out is not None and not w.is_contiguous():
        raise ValueError("analog_update(out=w) needs a contiguous w: the "
                         "kernel would update a copy")
    plain = backend(w) == "ref"
    f32 = torch.float32
    if noise is None and rng == "hash":
        seeds = fastrng.device_seeds(fastrng.seed_from_key(key),
                                     w.device).reshape(-1, 2)
        operands = ((w, dw, gamma, rho) if plain else
                    [t.contiguous() for t in (w, dw, gamma.to(f32),
                                              rho.to(f32))])
        if out is not None:
            _analog_update_hash_inplace_op(*operands, seeds, **kw)
            return w
        return _analog_update_hash_op(*operands, seeds, **kw)
    ubits, zeta = (noise if noise is not None
                   else make_noise(key, w.shape, w.device, rng))
    if plain:
        operands = (w, dw, gamma, rho, ubits, zeta)
    else:
        if ubits.dtype == torch.int64:
            ubits = ubits.to(torch.int32)  # same low 32 bits: the u32 pattern
        operands = [_view2d(t).contiguous() for t in (
            w, dw, gamma.to(f32), rho.to(f32), ubits, zeta.to(f32))]
    if out is not None:
        _analog_update_inplace_op(*operands, **kw)
        return w
    res = _analog_update_op(*operands, **kw)
    return res if plain else res.reshape(w.shape)


# ---------------------------------------------------------------------------
# hash normal draw
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::hash_normal", mutates_args=(),
                         device_types="cpu")
def hash_normal_op(seeds: Tensor, shape: List[int], salt: int) -> Tensor:
    """float32 normals of ``shape`` from ``(n, 2)`` int32 seed words, the n
    members of ``shape`` in memory order (``fastrng.hash_normal`` is the
    wrapper). CPU: the eager chain ``fastrng.hash_normal_ref``."""
    return fastrng.member_draw(fastrng.hash_normal_ref, seeds, tuple(shape),
                               salt, "cpu")


@hash_normal_op.register_kernel("cuda")
def _(seeds, shape, salt):
    out = torch.empty(shape, dtype=torch.float32, device=seeds.device)
    fastrng.hash_normal_cuda(seeds, out, salt)
    LAUNCHES["hash_normal"] += 1
    return out


@hash_normal_op.register_fake
def _(seeds, shape, salt):
    return seeds.new_empty(shape, dtype=torch.float32)


# ---------------------------------------------------------------------------
# hash device draw
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::hash_device", mutates_args=(),
                         device_types="cpu")
def hash_device_op(seeds: Tensor, shape: List[int], sigma_d2d: float,
                   sigma_pm: float, ref_mean: float, ref_std: float,
                   tau_min: float, tau_max: float) -> Tuple[Tensor, Tensor]:
    """float32 ``(gamma, rho)`` of ``shape`` from ``(n, 2)`` int32 seed
    words, the n members of ``shape`` in memory order, for the
    ``DeviceConfig`` scalars given (``hash_device`` is the wrapper). CPU:
    the eager chain ``fastrng.hash_device_ref``."""
    return fastrng.hash_device_ref(seeds, tuple(shape), "cpu",
                                   sigma_d2d=sigma_d2d, sigma_pm=sigma_pm,
                                   ref_mean=ref_mean, ref_std=ref_std,
                                   tau_min=tau_min, tau_max=tau_max)


@hash_device_op.register_kernel("cuda")
def _(seeds, shape, sigma_d2d, sigma_pm, ref_mean, ref_std, tau_min,
      tau_max):
    gamma = torch.empty(shape, dtype=torch.float32, device=seeds.device)
    rho = torch.empty_like(gamma)
    fastrng.hash_device_cuda(seeds, gamma, rho, sigma_d2d=sigma_d2d,
                             sigma_pm=sigma_pm, ref_mean=ref_mean,
                             ref_std=ref_std, tau_min=tau_min,
                             tau_max=tau_max)
    LAUNCHES["hash_device"] += 1
    return gamma, rho


@hash_device_op.register_fake
def _(seeds, shape, sigma_d2d, sigma_pm, ref_mean, ref_std, tau_min,
      tau_max):
    return (seeds.new_empty(shape, dtype=torch.float32),
            seeds.new_empty(shape, dtype=torch.float32))


def hash_device(seeds, shape, cfg) -> Tuple[Tensor, Tensor]:
    """A tile's device parameters ``(gamma, rho)``, float32 of ``shape``,
    drawn from the hash (salts 11, 13, 17) for the ``DeviceConfig`` ``cfg``:
    the op ``repro_torch::hash_device`` on the seeds' device. ``seeds`` are
    ``fastrng.device_seeds`` words, ``(2,)`` for ``shape`` whole or
    ``(n, 2)`` for its n leading members."""
    # positional: ``op_cost`` prices a record from these scalars
    return hash_device_op(seeds.reshape(-1, 2), [int(d) for d in shape],
                          *ref.device_scalars(cfg).values())


# ---------------------------------------------------------------------------
# analog MVM
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::analog_mvm", mutates_args=(),
                         device_types="cpu")
def _analog_mvm_op(x: Tensor, w: Tensor, noise: Tensor, inp_res: float,
                   inp_bound: float, out_res: float, out_bound: float,
                   out_noise: float) -> Tensor:
    return ref.analog_mvm_ref(x, w, noise, inp_res=inp_res,
                              inp_bound=inp_bound, out_res=out_res,
                              out_bound=out_bound, out_noise=out_noise)


@_analog_mvm_op.register_kernel("cuda")
def _(x, w, noise, inp_res, inp_bound, out_res, out_bound, out_noise):
    from .analog_matmul import analog_mvm_cuda

    out = analog_mvm_cuda(x, w, noise, inp_res=inp_res, inp_bound=inp_bound,
                          out_res=out_res, out_bound=out_bound,
                          out_noise=out_noise)
    LAUNCHES["analog_mvm"] += 1
    return out


@_analog_mvm_op.register_fake
def _(x, w, noise, inp_res, inp_bound, out_res, out_bound, out_noise):
    return x.new_empty((x.shape[0], w.shape[-1]))


def analog_mvm(x, w, key, *, inp_res: float, inp_bound: float,
               out_res: float, out_bound: float, out_noise: float,
               noise=None):
    """IO-quantized crossbar forward: ``x`` (..., K) @ ``w`` (K, N) ->
    (..., N) in ``x``'s dtype; see ``ref.analog_mvm_ref``.

    The output noise is ``prng.normal(key, (M, N))`` at the flattened
    output shape, as the JAX package draws it, unless ``noise`` (any shape
    of M * N elements) is given; then ``key`` is ignored and may be None.
    """
    io = dict(inp_res=float(inp_res), inp_bound=float(inp_bound),
              out_res=float(out_res), out_bound=float(out_bound),
              out_noise=float(out_noise))
    batch_shape = x.shape[:-1]
    n = w.shape[-1]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    noise = (prng.normal(key, (m, n), x.device) if noise is None
             else noise.reshape(m, n))
    if backend(x) != "ref":
        x2, w = x2.contiguous(), w.contiguous()
        noise = noise.to(torch.float32).contiguous()
    return _analog_mvm_op(x2, w, noise, **io).reshape(*batch_shape, n)


# ---------------------------------------------------------------------------
# SP filter
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::sp_filter", mutates_args=(),
                         device_types="cpu")
def _sp_filter_op(q: Tensor, p: Tensor, gamma: Tensor, rho: Tensor,
                  eta: float, tau_min: float,
                  tau_max: float) -> Tuple[Tensor, Tensor]:
    q_new, gp_sq, err_sq = ref.sp_filter_ref(q, p, gamma, rho, eta=eta,
                                             tau_min=tau_min, tau_max=tau_max)
    return q_new, torch.stack([gp_sq, err_sq])


@_sp_filter_op.register_kernel("cuda")
def _(q, p, gamma, rho, eta, tau_min, tau_max):
    from .sp_filter import sp_filter_cuda

    q_new, sums = sp_filter_cuda(q, p, gamma, rho, eta=eta, tau_min=tau_min,
                                 tau_max=tau_max)
    LAUNCHES["sp_filter"] += 1
    return q_new, sums


@_sp_filter_op.register_fake
def _(q, p, gamma, rho, eta, tau_min, tau_max):
    return torch.empty_like(q), q.new_empty((2,), dtype=torch.float32)


def sp_filter(q, p, gamma, rho, *, eta: float, tau_min: float,
              tau_max: float):
    """EMA tracking update (12) plus telemetry, any rank: returns
    ``(q_new, gp_sq, err_sq)``, the sums as 0-d float32 tensors on ``q``'s
    device (no host sync); see ``ref.sp_filter_ref``."""
    kw = dict(eta=float(eta), tau_min=float(tau_min), tau_max=float(tau_max))
    if backend(q) != "ref":
        f32 = torch.float32
        q, p = q.contiguous(), p.contiguous()
        gamma, rho = gamma.to(f32).contiguous(), rho.to(f32).contiguous()
    q_new, sums = _sp_filter_op(q, p, gamma, rho, **kw)
    return q_new, sums[0], sums[1]
