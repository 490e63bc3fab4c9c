"""Binding of the SP-tracking filter kernel (``csrc/sp_filter.cu``).

The CUDA kernel replaces the TPU kernel ``sp_filter_pallas``
(``src/repro/kernels/sp_filter.py``) with one launch per call: a fused
element-wise pass that writes ``q_new`` and reduces each block's two
telemetry sums to a partial pair; the block that finishes last adds the
partials in a fixed order (no float atomics: the sums are bit-identical
from run to run). It takes contiguous ``q``, ``p`` (float32 or bfloat16)
and float32 ``gamma``, ``rho`` of one shape, any rank, with 16-byte loads
where the operands are aligned and element loads where they are not.
``launch_plan`` fixes the grid, each block's range and the path from the
size and the alignment alone; ``sums_in_launch_order`` replays the
kernel's summation order in torch. ``kernels.ops.sp_filter`` is the
wrapper callers use; this module only checks operands and launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from . import cuda_build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 3
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])
THREADS = 256           # threads per block, as in the source
VEC = 4                 # elements per item on the 16-byte path
CHUNK = 32              # items: the unit of the blocks' ranges
MAX_BLOCKS = 132 * 4    # four blocks on each of the H100's 132 SMs

_FN = None
# One ticket per device (an int32 the kernel leaves at 0), made at first use
_TICKETS: Dict[int, torch.Tensor] = {}


def _fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("sp_filter").sp_filter_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut: ``items`` items of ``VEC`` elements (the
    16-byte path, ``vector``) or of one element, in ``chunks`` chunks of
    ``CHUNK`` items spread evenly over ``blocks`` blocks; on the vector path
    the last ``tail`` elements go to the last block's first threads."""
    vector: bool
    items: int
    tail: int
    chunks: int
    blocks: int

    def ranges(self) -> List[Tuple[int, int]]:
        """Each block's items ``[start, end)``, as the kernel computes them."""
        return [(b * self.chunks // self.blocks * CHUNK,
                 min(self.items, (b + 1) * self.chunks // self.blocks * CHUNK))
                for b in range(self.blocks)]


def launch_plan(size: int, aligned: bool) -> LaunchPlan:
    """The plan for ``size`` elements; ``aligned`` says that every operand
    starts on a whole vector (``vector_aligned``). A function of these two
    alone, so a given size and alignment always sums in the same order."""
    items, tail = divmod(size, VEC) if aligned else (size, 0)
    blocks = max(1, min(-(-items // THREADS), MAX_BLOCKS))
    return LaunchPlan(vector=aligned, items=items, tail=tail,
                      chunks=-(-items // CHUNK), blocks=blocks)


def vector_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a ``VEC``-element boundary (16 bytes
    for float32, 8 for bfloat16). A contiguous view at a storage offset may
    not; ``.contiguous()`` does not realign it."""
    return all(t.data_ptr() % (VEC * t.element_size()) == 0 for t in tensors)


def _launch_order(plan: LaunchPlan) -> torch.Tensor:
    """(blocks, THREADS, L) element indices in the order each thread adds
    them: round r gives thread t item start + r * THREADS + t of its
    block's range, then the tail; ``-1`` where a thread has nothing."""
    vec = VEC if plan.vector else 1
    starts, ends = (torch.tensor(x, dtype=torch.int64)
                    for x in zip(*plan.ranges()))
    rounds = max(1, int((-(-(ends - starts) // THREADS)).max()))
    i = (starts.view(-1, 1, 1)
         + THREADS * torch.arange(rounds).view(1, 1, -1)
         + torch.arange(THREADS).view(1, -1, 1))
    i = torch.where(i < ends.view(-1, 1, 1), i, -1)
    elem = i.unsqueeze(-1) * vec + torch.arange(vec)
    elem = torch.where(i.unsqueeze(-1) >= 0, elem, -1)
    order = elem.reshape(plan.blocks, THREADS, -1)
    tail = torch.full((plan.blocks, THREADS, 1), -1, dtype=torch.int64)
    tail[-1, :plan.tail, 0] = VEC * plan.items + torch.arange(plan.tail)
    return torch.cat([order, tail], dim=-1)


def _block_tree(x: torch.Tensor) -> torch.Tensor:
    """``block_sum2`` of the source over the last axis (THREADS values):
    shuffle-down halving within each warp, then over the warps' sums."""
    x = x.reshape(*x.shape[:-1], THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    x = x[..., 0]
    off = THREADS // 64
    while off:
        x = x[..., :off] + x[..., off:2 * off]
        off //= 2
    return x[..., 0]


def sums_in_launch_order(q, p, gamma, rho, *, eta: float, tau_min: float,
                         tau_max: float, plan: LaunchPlan):
    """``(gp_sq, err_sq)`` summed in float32 in the kernel's order under
    ``plan``: each thread's elements in turn, each block's fixed tree, then
    the partials in block order and the same tree. Bit-equal to the kernel
    on the same operands; on any device."""
    terms = ref.sp_filter_terms(q, p, gamma, rho, eta=eta, tau_min=tau_min,
                                tau_max=tau_max)[1:]
    order = _launch_order(plan).to(q.device)
    out = []
    for t in terms:
        flat = torch.cat([t.reshape(-1), t.new_zeros(1)])  # -1 -> 0.0
        vals = flat[order]
        acc = torch.zeros(vals.shape[:-1], dtype=torch.float32,
                          device=q.device)
        for c in range(vals.shape[-1]):
            acc = acc + vals[..., c]
        partials = _block_tree(acc)
        rows = -(-plan.blocks // THREADS)
        padded = torch.cat([partials, partials.new_zeros(
            rows * THREADS - plan.blocks)]).view(rows, THREADS)
        acc = torch.zeros(THREADS, dtype=torch.float32, device=q.device)
        for r in range(rows):
            acc = acc + padded[r]
        out.append(_block_tree(acc))
    return out[0], out[1]


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


def _ticket(device: torch.device) -> torch.Tensor:
    """The device's ticket, made and zeroed at its first call, which must
    not be inside a CUDA graph capture (the graph would own it)."""
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first sp_filter call on a device must "
                               "run outside a CUDA graph capture")
        t = torch.zeros(1, dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)  # zeroed before any stream uses it
        _TICKETS[device.index] = t
    return t


def sp_filter_cuda(q, p, gamma, rho, *, eta: float, tau_min: float,
                   tau_max: float):
    """One launch on the current stream; returns ``(q_new, gp_sq,
    err_sq)``, the sums as 0-d float32 tensors on the card (no host sync).
    Raises if the operands are not what the kernel takes or the launch is
    refused.

    The ticket that finds the last block is one per device: two calls
    running at the same time on two streams of one device would share it
    and must not overlap. Calls on one stream, and graphs replayed on one
    stream, are safe: the kernel puts the ticket back to 0 itself."""
    _check(q, p, gamma, rho)
    q_new = torch.empty_like(q)
    plan = launch_plan(q.numel(), vector_aligned(q, p, gamma, rho, q_new))
    ticket = _ticket(q.device)
    work = torch.empty(2 + 2 * plan.blocks, dtype=torch.float32,
                       device=q.device)  # the sums, then the partials
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_DTYPE_CODE[q.dtype], _DTYPE_CODE[p.dtype], q.data_ptr(),
            p.data_ptr(), gamma.data_ptr(), rho.data_ptr(), q_new.data_ptr(),
            work.data_ptr() + 8, work.data_ptr(), ticket.data_ptr(),
            plan.items, plan.chunks, plan.blocks, int(plan.vector), plan.tail,
            eta, 1.0 - eta, tau_min, tau_max, stream)
    if q.device.index == torch.cuda.current_device():
        err = _fn()(*args)
    else:
        with torch.cuda.device(q.device):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"sp_filter kernel launch failed: CUDA error {err}")
    return q_new, work[0], work[1]
