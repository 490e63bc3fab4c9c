"""Meshes: named grids of ranks.

Port of the JAX package's ``launch/mesh.py``. PyTorch has no SPMD
``jit``, so a mesh here is a grid of *processes*: one rank per device, a
mesh axis is a dimension of the rank grid, and rank ``r`` sits at the
row-major coordinates of ``r`` in ``shape`` (the first axis is the
slowest). A ``Mesh`` needs no process group to exist: the sharding rules
(``distributed.sharding``) compute specs from its axis names and sizes
alone, so the port's specs can be held against the JAX package's on the
production meshes (16x16 and 2x16x16). ``coords`` and ``group`` need a
process group whose world size is the mesh's size
(``distributed.runtime.init``), or ``distributed.runtime.abstract``
(the dry run), in which they stand for one rank with no process group.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

Axes = Union[str, Tuple[str, ...]]


class Mesh:
    """``axis_names`` (tuple) and ``shape`` ({axis: size}, in axis order),
    as ``jax.sharding.Mesh`` exposes them."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do "
                             f"not pair up")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self._groups: Optional[Dict[Tuple[str, ...], object]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"

    # -- the rank grid (needs a process group of the mesh's size) ---------
    def _world(self) -> Tuple[int, int]:
        import torch.distributed as dist

        from ..distributed import runtime

        r = runtime.abstract_rank(self)
        if r is not None:
            return r, self.size
        if not dist.is_initialized():
            raise RuntimeError(f"{self} needs a process group of world size "
                               f"{self.size}; none is initialized "
                               f"(distributed.runtime.init)")
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(f"{self} has {self.size} ranks but the process "
                               f"group has world size {world}")
        return dist.get_rank(), world

    def coords_of(self, rank: int) -> Dict[str, int]:
        """Coordinates of ``rank`` on each axis (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def coords(self) -> Dict[str, int]:
        """This rank's coordinates on each axis."""
        return self.coords_of(self._world()[0])

    def index(self, axes: Axes, coords: Optional[Dict[str, int]] = None) -> int:
        """Linear index of this rank (or of ``coords``) over ``axes``, the
        first named axis the slowest: the shard a spec entry ``axes`` gives
        this rank."""
        coords = self.coords() if coords is None else coords
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def axes_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def members(self, axes: Axes, rank: int) -> Tuple[int, ...]:
        """The ranks that share ``rank``'s coordinates on every axis outside
        ``axes``, in the order of ``index(axes)``."""
        mine = self.coords_of(rank)
        rest = [a for a in self.axis_names if a not in _axes(axes)]
        return tuple(r for r in range(self.size)
                     if all(self.coords_of(r)[a] == mine[a] for a in rest))

    def group(self, axes: Axes):
        """The process group of the ranks that share this rank's
        coordinates on every axis outside ``axes``; its group ranks follow
        ``index(axes)``. Every group of every axis subset is made at the
        first call, which every rank must therefore reach at the same
        point of its program (``torch.distributed.new_group`` is
        collective). In ``distributed.runtime.abstract`` mode it gives a
        ``runtime.GroupSpec`` and makes no process group."""
        from ..distributed import runtime

        rank, _ = self._world()
        key = tuple(a for a in self.axis_names if a in _axes(axes))
        if key != _axes(axes):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        if self.axes_size(key) == 1:
            return None
        if runtime.abstract_rank(self) is not None:
            return runtime.GroupSpec(key, self.members(key, rank))
        if self._groups is None:
            groups = {}
            names = self.axis_names
            for k in range(1, len(names) + 1):
                for subset in itertools.combinations(names, k):
                    if self.axes_size(subset) == 1:
                        continue
                    rest = [a for a in names if a not in subset]
                    for fixed in itertools.product(
                            *(range(self.shape[a]) for a in rest)):
                        pinned = dict(zip(rest, fixed))
                        members = [r for r in range(self.size)
                                   if all(self.coords_of(r)[a] == v
                                          for a, v in pinned.items())]
                        g = runtime.new_group(members)
                        if rank in members:
                            groups[subset] = g
            self._groups = groups
        return self._groups[key]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks single-pod, or 2x16x16 = 512 across 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """Elastic variant: any (pods, data, model) factorization."""
    return Mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pods: int = 1) -> Mesh:
    """A small mesh (tests, one host). ``pods > 1`` adds the leading "pod"
    axis, with the production mesh's axis names."""
    if pods > 1:
        return Mesh((pods, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))
