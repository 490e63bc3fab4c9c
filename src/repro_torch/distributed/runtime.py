"""The process-group runtime of the port: bring-up and the collectives.

JAX needs no such module: its meshes span the devices of one program.
The port runs one process per rank, so this module starts the process
group and keeps, in one place, the few collectives the trainer and the
checkpoint use.

- Bring-up: ``init()`` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; rendezvous
  ``env://``), or takes ``init(rank, world, init_file)`` from a caller that
  spawned the ranks itself; that rendezvous is a file (``file://``), so
  concurrent runs on one host never race for a TCP port.
- Backend: NCCL when every rank of the host has a card of its own; gloo
  when ranks share a card (NCCL refuses two ranks on one device) or run on
  the CPU. Every process group gets a 60 s timeout, so a hung collective
  fails instead of waiting forever.
- Route: gloo's CUDA support differs from collective to collective and
  from build to build, so a CUDA tensor under gloo always goes through host
  memory: copied to the CPU, reduced or gathered there, copied back, on
  every call (``route``); a CPU tensor under NCCL (a host leaf) goes
  through the rank's card the same way. No call probes or falls back. ``STATS`` counts
  the calls, bytes and host-clock seconds (the copies included) of the
  collectives under each caller's label, and the bytes copied when
  staging ("staged"). Collectives over a model group carry labels that
  start with ``model/all_reduce/`` or ``model/all_gather/``, so a step's
  model-group traffic reads apart from its data-group traffic.
- Only collectives that torch 2.11 and 2.13 both have: ``all_gather`` of a
  list and ``all_reduce`` (a reduce-scatter is an all-reduce then a slice),
  ``scatter`` / ``gather`` from and to one rank of a group (a serve
  step moves a cache block that one data rank holds into the rows each
  rank computes, and back), and ``broadcast`` from one rank of a group
  (a one-row serve step, which every data rank computes, reads the block
  of one period from the rank that holds it).
- Abstract mode (``abstract(mesh, rank)``, the dry run): ``mesh.group``
  gives ``GroupSpec`` descriptors, with no process group, and the
  collectives on them return empty tensors of the right per-rank shape on
  their input's device (``meta`` in the dry run), counted in ``STATS``
  under their labels as a real run counts them. Nothing changes outside
  the context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)

_STATE: Dict[str, object] = {"backend": None, "device": None}
STATS: Dict[str, Dict[str, float]] = {}
_ABSTRACT: Dict[str, object] = {"mesh": None, "rank": 0}


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """A group of ranks in abstract mode: its mesh axes and members (in
    group-rank order); no process group stands behind it."""
    axes: Tuple[str, ...]
    ranks: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)


@contextlib.contextmanager
def abstract(mesh, rank: int = 0):
    """Run as rank ``rank`` of ``mesh`` with no process group: inside,
    ``mesh.coords()`` is ``rank``'s, ``mesh.group`` gives ``GroupSpec``s,
    and ``all_gather``, ``all_reduce`` and ``barrier`` only compute shapes
    and count (see the module docstring)."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside {mesh}")
    saved = dict(_ABSTRACT)
    _ABSTRACT.update(mesh=mesh, rank=rank)
    try:
        yield
    finally:
        _ABSTRACT.update(saved)


def abstract_rank(mesh) -> Optional[int]:
    """This process's rank of ``mesh`` in abstract mode, else None."""
    return _ABSTRACT["rank"] if _ABSTRACT["mesh"] is mesh else None


def reset_stats() -> None:
    STATS.clear()


def _count(kind: str, nbytes: int, seconds: float) -> None:
    s = STATS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += seconds


def pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of its
    own, gloo otherwise (ranks sharing a card, or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init(rank: Optional[int] = None, world: Optional[int] = None,
         init_file: Optional[str] = None, device="cuda") -> torch.device:
    """Start the default process group; returns this rank's device.

    With no arguments the ranks come from torchrun's environment. A caller
    that spawned the ranks passes ``rank``, ``world`` and ``init_file`` (a
    path no earlier run has used; every rank passes the same one), and its
    ranks are all on this host. ``device`` is "cpu" or "cuda": rank ``r``
    of the host takes card ``r`` when there are enough cards, else every
    rank shares card ``r % count``."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if rank is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        method = "env://"
    else:
        if world is None or init_file is None:
            raise ValueError("pass rank, world and init_file together")
        local_rank, local_world = rank, world
        method = "file://" + os.path.abspath(init_file)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = pick_backend(device, local_world)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=method, rank=rank,
                            world_size=world, timeout=TIMEOUT, **kw)
    _STATE.update(backend=backend, device=device)
    return device


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None)


def backend() -> Optional[str]:
    return _STATE["backend"]


def rank() -> int:
    if _ABSTRACT["mesh"] is not None:
        return _ABSTRACT["rank"]
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    if _ABSTRACT["mesh"] is not None:
        return _ABSTRACT["mesh"].size
    return dist.get_world_size() if dist.is_initialized() else 1


def world_of(group) -> int:
    """The number of ranks in ``group`` (None: a group of one)."""
    if group is None:
        return 1
    if isinstance(group, GroupSpec):
        return group.size
    return dist.get_world_size(group)


def new_group(ranks: List[int]):
    """A process group over ``ranks`` with the runtime's backend and
    timeout (collective: every rank calls it for every group)."""
    return dist.new_group(ranks, timeout=TIMEOUT, backend=backend())


def device() -> Optional[torch.device]:
    """This rank's device (``init``'s)."""
    return _STATE["device"]


def route(t: torch.Tensor) -> str:
    """Where a collective on ``t`` runs: "host" (gloo with a CUDA tensor:
    staged through host memory), "device" (NCCL with a CPU tensor, such as
    a key: staged through this rank's card), else "direct"."""
    if t.is_cuda and backend() == "gloo":
        return "host"
    if not t.is_cuda and backend() == "nccl":
        return "device"
    return "direct"


_WIRE = (torch.float32, torch.float64, torch.int32, torch.int64, torch.int8,
         torch.uint8)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype every backend gathers: gathering moves bytes, so a
    dtype outside ``_WIRE`` (bf16, int16, bool, ...) travels as its bytes,
    a uint8 view whose last dim is ``element_size`` times longer."""
    t = t.contiguous()
    if t.dtype in _WIRE:
        return t
    return t.view(torch.uint8)


def _run(label: str, t: torch.Tensor, collective) -> torch.Tensor:
    """``collective(x)`` on ``t`` as the route says (staged: copied to the
    host, run there, copied back), counted under ``label``: calls, bytes
    of ``t`` and host-clock seconds, the copies included (a direct CUDA
    collective is timed as enqueued)."""
    t0 = time.perf_counter()
    where = {"host": "cpu", "device": device()}.get(route(t))
    staged = where is not None
    x = t.contiguous()
    out = collective(x.to(where) if staged else x)
    if staged:
        out = out.to(t.device)
    _count(label, t.numel() * t.element_size(), time.perf_counter() - t0)
    if staged:
        _count("staged", 2 * t.numel() * t.element_size(), 0.0)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0,
               label: str = "all_gather") -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group-rank order; ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    if isinstance(group, GroupSpec):
        shape = list(t.shape)
        shape[dim] *= group.size
        _count(label, t.numel() * t.element_size(), 0.0)
        return t.new_empty(shape)
    n = dist.get_world_size(group)

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    return _run(label, _bits(t), gather).view(t.dtype)


def barrier() -> None:
    """Return when every rank of the world has called ``barrier`` (an
    all-reduce of one element, so it takes the route of any collective)."""
    if _ABSTRACT["mesh"] is not None:
        _count("barrier", 4, 0.0)
    elif dist.is_initialized():
        all_reduce(torch.zeros(1), dist.group.WORLD, label="barrier")


def all_reduce(t: torch.Tensor, group, op: str = "sum",
               label: str = "all_reduce") -> torch.Tensor:
    """The group's SUM or MAX of ``t`` (a new tensor, in ``t``'s dtype;
    ``t`` itself when ``group`` is None). It never writes ``t``, so an
    autograd function may call it on its input: ``models.common``'s
    tensor-parallel operators do, forward and backward."""
    if group is None:
        return t
    if isinstance(group, GroupSpec):
        if op not in ("sum", "max"):
            raise KeyError(op)
        _count(label, t.numel() * t.element_size(), 0.0)
        return torch.empty_like(t)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def reduce(x):
        x = x.clone() if x is t else x
        dist.all_reduce(x, op=rop, group=group)
        return x

    return _run(label, t, reduce)


def _group_rank(group) -> int:
    if isinstance(group, GroupSpec):
        return group.ranks.index(_ABSTRACT["rank"])
    return dist.get_rank(group)


def _global_rank(group, group_rank: int) -> int:
    if isinstance(group, GroupSpec):
        return group.ranks[group_rank]
    return dist.get_global_rank(group, group_rank)


def scatter(t: torch.Tensor, group, src: int,
            label: str = "scatter") -> torch.Tensor:
    """Group rank ``src``'s ``t`` cut into equal chunks along dim 0, chunk
    ``i`` to group rank ``i``: every rank returns its chunk. Every rank
    passes a ``t`` of the same shape and dtype; only ``src``'s is read.
    Counted under ``label`` with the chunk's bytes (what each rank
    receives); ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    n = world_of(group)
    shape = (t.shape[0] // n,) + tuple(t.shape[1:])
    nbytes = math.prod(shape) * t.element_size()
    if isinstance(group, GroupSpec):
        _count(label, nbytes, 0.0)
        return t.new_empty(shape)
    t0 = time.perf_counter()
    where = {"host": "cpu", "device": device()}.get(route(t))
    x = _bits(t)
    x = x.to(where) if where is not None else x
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    parts = list(x.chunk(n)) if _group_rank(group) == src else None
    dist.scatter(out, parts, src=_global_rank(group, src), group=group)
    out = out.to(t.device).view(t.dtype)
    _count(label, nbytes, time.perf_counter() - t0)
    if where is not None:
        _count("staged", 2 * nbytes, 0.0)
    return out


def broadcast(t: torch.Tensor, group, src: int,
              label: str = "broadcast") -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of the group: ``t`` itself
    on ``src``, a new tensor on the others (their ``t`` gives the shape
    and dtype and is never written). Counted under ``label`` with ``t``'s
    bytes (what each rank receives); ``t`` itself when ``group`` is
    None."""
    if group is None:
        return t
    nbytes = t.numel() * t.element_size()
    mine = _group_rank(group) == src
    if isinstance(group, GroupSpec):
        _count(label, nbytes, 0.0)
        return t if mine else torch.empty_like(t)
    t0 = time.perf_counter()
    where = {"host": "cpu", "device": device()}.get(route(t))
    if mine:
        x = _bits(t)
        x = x.to(where) if where is not None else x
    else:
        x = _bits(torch.empty_like(t, device=where or t.device,
                                   memory_format=torch.contiguous_format))
    dist.broadcast(x, src=_global_rank(group, src), group=group)
    out = t if mine else x.to(t.device).view(t.dtype)
    _count(label, nbytes, time.perf_counter() - t0)
    if where is not None:
        _count("staged", 2 * nbytes, 0.0)
    return out


def gather(t: torch.Tensor, group, dst: int,
           label: str = "gather") -> Optional[torch.Tensor]:
    """The group's tensors (equal shapes) concatenated along dim 0 in
    group-rank order, on group rank ``dst``; None on the other ranks.
    Counted under ``label`` with ``t``'s bytes (what each rank sends);
    ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    n = world_of(group)
    nbytes = t.numel() * t.element_size()
    mine = _group_rank(group) == dst
    if isinstance(group, GroupSpec):
        _count(label, nbytes, 0.0)
        return t.new_empty((n * t.shape[0],) + tuple(t.shape[1:])) \
            if mine else None
    t0 = time.perf_counter()
    where = {"host": "cpu", "device": device()}.get(route(t))
    x = _bits(t)
    x = x.to(where) if where is not None else x
    parts = [torch.empty_like(x) for _ in range(n)] if mine else None
    dist.gather(x, parts, dst=_global_rank(group, dst), group=group)
    out = torch.cat(parts).to(t.device).view(t.dtype) if mine else None
    _count(label, nbytes, time.perf_counter() - t0)
    if where is not None:
        _count("staged", 2 * nbytes, 0.0)
    return out
