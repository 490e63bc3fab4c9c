"""AnalogTrainer: wires a PyTorch loss function to the analog tile algorithms.

Port of the JAX package's ``core/trainer.py``. Given a loss over a
parameter tree (nested dicts of tensors) and an ``AnalogPlan`` deciding
which leaves live on which analog tile stacks, ``train_step`` runs

  1. ``begin_step`` (chopper draw / Q~ sync, Alg. 3 lines 3-6),
  2. forward/backward (autograd) on the effective parameter tree,
  3. digital leaves -> SGD/Adam; analog leaves -> the pulse-based update.

The grouped engine keeps tiles in a class-keyed ``TileBank``. Its
``update_backend="vmap"`` runs the per-tile update in a loop over the
members of each class, with per-tile keys; ``"fused"`` runs one batched
update over each whole class stack (one 3-D kernel launch per array).
Either runs on the class flattened to one stack of tiles, which takes the
place of ``lax.scan`` over its groups, so ``scan_groups`` has no effect
on results here. ``engine="looped"`` keeps the per-tile dict
layout. Keys fold a CRC of the tile path or of the group's member paths,
as in the JAX package, so both packages draw the same bits.

PyTorch runs eagerly, so there is nothing to compile: ``jit_step()``
returns the donated step ``train_step_``, as the reference's ``jit_step``
donates its state (``donate_argnums=(0,)``). It writes every state leaf
into that leaf's own storage: the pulse updates of P and W through K1's
in-place mode (``repro_torch::analog_update_``), H, Q and the per-tile
counters through ``out=`` and in-place ops, each member of the per-tile
loop into its slot of the class stack (nothing is restacked), the digital
parameters and moments through ``apply_opt(inplace=True)``, and the host
key and step counter. It returns the state it was given, bit-equal to what
``train_step`` (pure: it leaves its input as it was) returns; a caller that
needs the state from before a donated step keeps a copy.
``jit_step(donate=False)`` returns ``train_step``. The state's step counter
and key stay on the host; tile state lives on the parameters' device.

``mesh=`` (a ``launch.mesh.Mesh`` of more than one rank, one process per
rank over ``distributed.runtime``) does what the JAX package's sharded
step does, with its implicit collectives made explicit. Every rank holds
its block of each state leaf by ``distributed.sharding.state_shardings``
(``self.shardings``): tile state and optimizer moments ZeRO-sharded over
the data axes, the model axis on the member dims its rules name; host
leaves (key, step, seeds) whole and equal on every rank. In the step:
  1. ``begin_step`` runs on each rank's blocks as they are stored (it draws
     no noise and reduces nothing over a tile);
  2. (``loss_and_grads``) each rank computes the effective weights of its
     blocks and gathers them and the digital parameters over the data
     axes; the model axis too unless ``tensor_parallel`` (a
     ``sharding.tp_layout``) splits that weight's compute, in which case
     the rank keeps its compute block: the block it stores where the
     stored spec puts the model axis on the split dim, else its slice cut
     locally after the gather (a class whose members' rules conflict
     stores its member dims whole). A weight that a rank stores split
     but computes with whole (SSD's ``wb``/``wc`` and their convolutions
     at one group, K/V heads that do not divide) is gathered over the
     model axis (``runtime.STATS`` label ``model/all_gather/whole``); a
     split weight never is. ``tp_layout`` splits dense attention,
     cross-attention, MLA, the RG-LRU, SSD, the MLP, the experts and the
     vocabulary, each where the reference's hints shard it, in the
     decoder and in an encoder-decoder's encoder. The forward and
     backward run on its
     rows of the global batch (under ``microbatch`` its share of each
     global microbatch) inside ``models.common.data_parallel`` (a
     statistic over the batch, the MoE router's, is the global batch's)
     and ``models.common.model_parallel`` (the split modules' all-reduces
     over the model group); the gradients, loss and aux are averaged over
     the data axes, the split weights' gradients on their blocks, which
     are then gathered whole over the model group in one all-gather of
     their bytes (a concatenation, exact). Without ``tensor_parallel``
     the model axis only shards storage and every rank computes whole;
  3. the digital update runs on each rank's block of the moments (its
     stored parameter block cut over the moments' data dims), with
     clipping on the whole averaged gradients; the pulse update runs on
     whole tiles: where the stack axis carries the data axes, each rank
     updates its rows, with each tile's members gathered whole over the
     model axis and the keys split over the whole group, then sliced; the
     'fused' backend splits the flattened (C*n) stack when only that
     divides; elsewhere every rank gathers the stack, updates all of it
     and keeps its block. ``distributed.sharding.shard_stacked_call``
     makes each row split, as in the reference. Per-tile key streams and
     noise do not depend on a tile's position in a stack, so given equal
     gradients every rank's rows are bit-equal to the one-process update.
     Per-tile metrics are gathered in stack order before the mean or sum.
     The donated step then writes the rank's cut of each updated leaf into
     its stored block, one copy a leaf where the update ran on a gathered
     or cut copy (``_write_back``).
A row split sums two partial products and SSD's gated norm two partial
sums of squares, so with ``tensor_parallel`` the gradients differ from
one process's in float sum order only.
"""
from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import prng
from ..distributed import runtime
from ..distributed import sharding as shd
from ..kernels.ref import div
from ..trace import span
from . import algorithms as alg
from .digital_opt import (DigitalOptConfig, ScheduleConfig, apply_opt,
                          clip_by_global_norm, init_opt, lr_at)
from .paths import TensorSpec, flatten_with_path, tree_map, tree_map_with_path
from .plan import AnalogPlan, TilePolicy, legacy_plan, plan_partition
from .tile import (TileBank, TileConfig, abstract_tile,
                   abstract_tile_group, group_policies, group_tiles,
                   init_tile, stack_tiles)

logger = logging.getLogger("repro_torch.plan")

# leaf names the port keeps on the host: the step counter, the key and the
# tile seeds (key data, see ``prng``)
HOST_LEAVES = ("key", "step", "seed_p", "seed_w")


def _crc_fold(key, name: str):
    """Fold a stable CRC of ``name`` into ``key`` (path-keyed RNG)."""
    return prng.fold_in(key, zlib.crc32(name.encode()))


PathPredicate = Callable[[str, Any], bool]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    tile: TileConfig = TileConfig()
    digital: DigitalOptConfig = DigitalOptConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    # gradient accumulation over `microbatch` slices of the batch
    microbatch: int = 1
    accum_dtype: Any = torch.float32
    engine: str = "grouped"     # grouped | looped
    # the JAX package scans same-structure classes; a loop here either way
    scan_groups: bool = True

    def __post_init__(self):
        if self.engine not in ("grouped", "looped"):
            raise ValueError(f"unknown engine {self.engine!r}")


def default_analog_filter(path: str, leaf) -> bool:
    """Analog-tile every >=2-D weight except embeddings/heads."""
    if getattr(leaf, "ndim", 0) < 2:
        return False
    lowered = path.lower()
    return not any(s in lowered for s in ("embed", "vocab", "lm_head", "pos"))


def partition_params(params, analog_filter: PathPredicate):
    """Split a param tree into (digital tree with None at analog slots,
    {path: leaf} analog dict)."""
    analog = {p: leaf for p, leaf in flatten_with_path(params)
              if analog_filter(p, leaf)}
    digital = tree_map_with_path(
        lambda p, leaf: None if p in analog else leaf, params)
    return digital, analog


def _group_tile_cfg(bank: TileBank, group: str, default: TileConfig) -> TileConfig:
    pol = bank.policy(group)
    return pol.tile if (pol is not None and pol.tile is not None) else default


def effective_weights(tiles, tcfg: TileConfig, policies=None) -> Dict[str, torch.Tensor]:
    """{path: model-space effective weight} for a TileBank (one broadcast
    ``effective_weight`` per class stack, then per-member views) or a
    per-tile dict (``policies``: optional {path: TileConfig})."""
    if isinstance(tiles, TileBank):
        out = {}
        pidx = dict(tiles.index)
        for cname, gnames in tiles.class_index:
            gcfg = _group_tile_cfg(tiles, gnames[0], tcfg)
            eff = alg.effective_weight(tiles.classes[cname], gcfg)
            for ci, g in enumerate(gnames):
                for i, p in enumerate(pidx[g]):
                    out[p] = eff[ci, i]
        return out
    policies = policies or {}
    return {p: alg.effective_weight(ts, policies.get(p, tcfg))
            for p, ts in tiles.items()}


def merge_effective(digital, tiles, tcfg: TileConfig, policies=None):
    """The full parameter tree with analog slots filled by their effective
    (model-space) weights."""
    eff = effective_weights(tiles, tcfg, policies)
    return tree_map_with_path(
        lambda p, leaf: eff[p] if (leaf is None and p in eff) else leaf,
        digital, keep_none=True)


def extract_analog_grads(grads, tiles) -> Dict[str, torch.Tensor]:
    return {p: g for p, g in flatten_with_path(grads) if p in tiles}


def mask_digital_grads(grads, tiles):
    return tree_map_with_path(lambda p, g: None if p in tiles else g, grads)


class TrainState(dict):
    """step, key (host), params (digital; None at analog), tiles, opt."""


def _value_and_grad(loss_fn, params, batch, rng):
    """(loss, aux, grads) of ``loss_fn(params, batch, rng)`` w.r.t. every
    leaf of ``params`` (autograd; grads of unused leaves are zeros)."""
    flat = flatten_with_path(params)
    leaves = {p: leaf.detach().requires_grad_(True) for p, leaf in flat}
    tree = tree_map_with_path(lambda p, _: leaves[p], params)
    with torch.enable_grad():
        loss, aux = loss_fn(tree, batch, rng)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    by_path = {p: (torch.zeros_like(leaf) if g is None else g)
               for (p, leaf), g in zip(leaves.items(), grads)}
    grads = tree_map_with_path(lambda p, _: by_path[p], params)
    aux = {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}
    return loss.detach(), aux, grads


def _per_tile(fn, inplace: bool = False):
    """Lift a per-tile ``fn(tile_state, key, *extras)`` to one group stack:
    a loop over the members, each with its own raw (2,) key, results
    restacked along a new leading axis. ``inplace``: ``fn`` writes each
    member into its slot view ``leaf[i]`` of the stack, which is returned
    as it is; only the per-tile metrics are stacked."""
    def run(gstate, keys_raw, *extras):
        n = keys_raw.shape[0]
        outs = [fn(tree_map(lambda l, i=i: l[i], gstate), keys_raw[i],
                   *(tree_map(lambda l, i=i: l[i], e) for e in extras))
                for i in range(n)]
        if not inplace:
            return tree_map(lambda *ls: torch.stack(ls), *outs)
        if isinstance(outs[0], tuple):
            return gstate, tree_map(lambda *ls: torch.stack(ls),
                                    *(m for _, m in outs))
        return gstate
    return run


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same elements (storage identity, as
    ``analysis.graph_contracts`` tells it, on ``meta`` too)."""
    def steps(t):  # a stride over a dim of size 1 is never taken
        return [st for n, st in zip(t.shape, t.stride()) if n > 1]
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and steps(a) == steps(b))


def _write_back(stored, res):
    """Write each leaf of ``res`` into the leaf of ``stored`` at its path
    that it does not already view (one copy each); returns ``stored``."""
    def put(dst, src):
        src = src.reshape(dst.shape)
        if not _same_memory(dst, src):
            dst.copy_(src)
        return dst
    tree_map(put, stored, res)
    return stored


def _state_part(res):
    return res[0] if isinstance(res, tuple) else res


def _run_class(vfn, cstate, kr, extras):
    """``vfn`` over one class stack (C, m, *member) with keys (C, m, 2), as
    one flattened (C*m) stack: the 'fused' backend's batched update, or
    the per-tile loop of the others, whose tiles are independent, so the
    class needs no restack of per-group results; the output gets the
    leading (C, m) axes back. The flattened stack is a view of
    ``cstate``, so a ``vfn`` that writes the stack it is given writes
    ``cstate``."""
    C = kr.shape[0]

    def flat(t):
        return tree_map(lambda l: l.reshape((-1,) + tuple(l.shape[2:])), t)

    res = vfn(flat(cstate), flat(kr), *(flat(e) for e in extras))
    return tree_map(lambda l: l.reshape((C, l.shape[0] // C)
                                        + tuple(l.shape[1:])), res)


def _map_result(res, state_fn, metric_fn):
    """Map a class result, ``state`` or ``(state, metrics)``:
    ``state_fn(slot_path, leaf)`` over the state, ``metric_fn`` over the
    metrics."""
    if isinstance(res, tuple):
        st, m = res
        return tree_map_with_path(state_fn, st), tree_map(metric_fn, m)
    return tree_map_with_path(state_fn, res)


class AnalogTrainer:
    def __init__(self, loss_fn, cfg: TrainerConfig,
                 analog_filter: Optional[PathPredicate] = None, mesh=None, *,
                 plan: Optional[AnalogPlan] = None, tensor_parallel=None):
        """``plan``: an AnalogPlan mapping parameter paths to TilePolicies;
        when omitted, ``(cfg.tile, analog_filter)`` maps onto a one-rule
        plan behind a one-time DeprecationWarning. ``mesh``: a
        ``launch.mesh.Mesh`` whose size is the process group's world size
        (see the module docstring); a mesh of one rank is one process.
        ``tensor_parallel``: the ``distributed.sharding.tp_layout`` of the
        model ``loss_fn`` runs, over ``mesh``'s model axis; without it the
        model axis only shards storage and compute is replicated."""
        self.loss_fn = loss_fn
        self.cfg = cfg
        if plan is None:
            plan = legacy_plan(cfg.tile, analog_filter or default_analog_filter)
        elif analog_filter is not None:
            raise ValueError("pass either plan= or analog_filter=, not both")
        self.plan = plan
        self.analog_filter = analog_filter
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.tp = None
        if tensor_parallel is not None and tensor_parallel.size > 1:
            msize = (shd.mesh_axis_sizes(self.mesh)[3] if self.mesh is not None
                     else 1)
            if msize != tensor_parallel.size:
                raise ValueError(
                    f"a layout over {tensor_parallel.size} model ranks on a "
                    f"mesh whose model axis has {msize}")
            self.tp = tensor_parallel
        # NamedShardings of the state (the layout of every rank's blocks),
        # set by init / abstract_state / shard_state under a mesh
        self.shardings = None
        self._specs: Dict[str, Any] = {}
        self._path_tile_cfgs: Dict[str, TileConfig] = {}

    def _remember_path_cfgs(self, analog, policies) -> None:
        self._path_tile_cfgs.update(
            {p: (policies[p].tile or self.cfg.tile) for p in analog})

    def _tile_cfg_of(self, path: str) -> TileConfig:
        """Static TileConfig of one analog path (looped engine)."""
        cfg = self._path_tile_cfgs.get(path)
        if cfg is not None:
            return cfg
        try:
            pol = self.plan.policy_for(path)
        except Exception:  # leaf-dependent legacy predicate
            return self.cfg.tile
        return pol.tile if (pol is not None and pol.tile is not None) \
            else self.cfg.tile

    def describe_plan(self, params) -> str:
        """``plan: N analog paths -> K groups, algorithms {...}, M digital
        leaves``."""
        digital, analog, policies = plan_partition(params, self.plan)
        index = group_tiles({p: tuple(analog[p].shape) for p in analog},
                            self.cfg.tile, policies)
        pols = group_policies(index, policies) or {}
        algos: Dict[str, int] = {}
        for g, paths in index:
            pol = pols.get(g)
            a = pol.tile.algorithm if pol is not None else self.cfg.tile.algorithm
            algos[a] = algos.get(a, 0) + len(paths)
        n_dig = len(flatten_with_path(digital))
        algos_s = "{" + ", ".join(f"{a}: {n}" for a, n in sorted(algos.items())) + "}"
        return (f"plan: {len(analog)} analog paths -> {len(index)} groups, "
                f"algorithms {algos_s}, {n_dig} digital leaves")

    def _grouped_apply(self, bank: TileBank, make_vfn, key, extras=(),
                       members: str = "whole", inplace: bool = False):
        """Apply one stack-level function per class.

        ``make_vfn(tcfg)`` returns ``vfn(stack, keys_raw, *extra)`` over a
        (m, *member) stack of tiles. Per-group keys fold a CRC of the
        group's member paths. Each class runs as one flattened
        (C*n, *member) stack (``_run_class``). ``extras``: {class-name: (C, n, ...) whole tensors}. Returns
        {class-name: vfn output with a leading class axis}: under a mesh,
        state leaves as this rank's blocks and metrics whole.
        ``members="local"`` (a function that draws no noise and reduces
        nothing over a tile) lets it run on the blocks as stored.
        ``inplace`` (``vfn`` writes the stack it is given): each class's
        state is its stored stack, written in place; what ran on a copy (a
        gathered or cut one under a mesh) is written back into it.
        """
        index = dict(bank.index)

        def keys_raw(paths):
            return prng.split(_crc_fold(key, "|".join(paths)), len(paths))

        out = {}
        for cname, gnames in bank.class_index:
            tcfg = _group_tile_cfg(bank, gnames[0], self.cfg.tile)
            vfn = make_vfn(tcfg)
            fused = tcfg.update_backend == "fused"
            kr = torch.stack([keys_raw(index[g]) for g in gnames])
            ex = [e[cname] for e in extras]
            cstate = bank.classes[cname]
            if self.mesh is None:
                res = _run_class(vfn, cstate, kr, ex)
            else:
                res = self._run_class_sharded(
                    f"tiles/{cname}", vfn, fused, cstate, kr, ex, members)
            if inplace:
                _write_back(cstate, _state_part(res))
                res = (cstate, res[1]) if isinstance(res, tuple) else cstate
            out[cname] = res
        return out

    def _run_class_sharded(self, prefix, vfn, fused, cstate, kr, extras,
                           members):
        """One class under the mesh: ``cstate`` holds this rank's blocks
        (specs at ``prefix/<slot>``), ``kr`` (C, n, 2) the whole group's
        keys, ``extras`` whole tensors. See the module docstring."""
        mesh = self.mesh
        spec = lambda p: self._specs[f"{prefix}/{p}"]  # noqa: E731
        C, n = kr.shape[:2]
        whole_members = members == "whole"

        def on_rows(st, k, *ex):
            # this rank's rows of the stack, each member whole if asked
            if whole_members:
                st = tree_map_with_path(lambda p, leaf: shd.gather(
                    leaf, spec(p), mesh, dims=range(2, leaf.ndim)), st)
            res = _run_class(vfn, st, k, list(ex))
            if whole_members:
                res = _map_result(res, lambda p, leaf: shd.shard(
                    leaf, spec(p), mesh, dims=range(2, leaf.ndim)),
                    lambda m: m)
            return res

        res = shd.shard_stacked_call(on_rows, mesh, n, cstate, kr, *extras,
                                     axis=1)
        if res is not None:
            rows = shd.stacked_rows(mesh, n, axis=1)
            return _map_result(
                res, lambda p, leaf: leaf if spec(p)[1] == rows[1]
                else shd.gather(leaf, rows, mesh),
                lambda m: shd.gather(m, rows, mesh))
        if members == "local":
            if extras:
                raise ValueError("members='local' takes no per-tile inputs")
            return _run_class(vfn, cstate, kr, [])
        whole = tree_map_with_path(
            lambda p, leaf: shd.gather(leaf, spec(p), mesh), cstate)
        if fused:
            # the reference's flattened (C*n) stack, split over the data axes
            def flat(t):
                return t.reshape((C * n,) + tuple(t.shape[2:]))

            res = shd.shard_stacked_call(
                vfn, mesh, C * n, tree_map(flat, whole), flat(kr),
                *(flat(e) for e in extras))
            if res is not None:
                frows = shd.stacked_rows(mesh, C * n)

                def uncut(t):
                    t = shd.gather(t, frows, mesh)
                    return t.reshape((C, n) + tuple(t.shape[1:]))

                return _map_result(
                    res, lambda p, leaf: shd.shard(uncut(leaf), spec(p), mesh),
                    uncut)
        res = _run_class(vfn, whole, kr, extras)
        return _map_result(res, lambda p, leaf: shd.shard(leaf, spec(p), mesh),
                           lambda m: m)

    # -- mesh: layout, effective weights, reductions -------------------------
    def _set_shardings(self, global_state) -> None:
        self.shardings = shd.state_shardings(global_state, self.mesh)
        self._specs = {p: s.spec for p, s in flatten_with_path(self.shardings)}

    def shard_state(self, state) -> TrainState:
        """This rank's blocks of a whole state (every rank passes the same
        state); records the layout in ``self.shardings``."""
        self._set_shardings(state)
        return shd.shard_tree(state, self.shardings)

    def gather_state(self, state) -> TrainState:
        """The whole state from every rank's blocks (collective)."""
        return shd.gather_tree(state, self._layout())

    def _layout(self):
        if self.shardings is None:
            raise RuntimeError("the trainer has no state layout: call init, "
                               "abstract_state or shard_state under the mesh "
                               "first")
        return self.shardings

    def effective_params(self, state):
        """The whole parameter tree with the analog slots filled by their
        effective weights (under a mesh: gathered from every rank's blocks,
        collective)."""
        tiles = state["tiles"]
        params = state["params"]
        if self.mesh is not None:
            params = shd.gather_tree(params, self._layout()["params"])
        return self._merged(params, tiles, self._path_cfgs(tiles))

    def _path_cfgs(self, tiles):
        return (None if isinstance(tiles, TileBank) else
                {p: self._tile_cfg_of(p) for p in tiles})

    def _merged(self, params, tiles, path_cfgs, compute: bool = False):
        """``merge_effective`` of whole digital ``params``; under a mesh each
        rank computes the effective weight of its blocks (the per-tile
        scalars cut to its rows) and gathers it whole, or, for the forward
        (``compute``) under ``tensor_parallel``, its compute block
        (``_compute_gather``)."""
        if self.mesh is None:
            return merge_effective(params, tiles, self.cfg.tile, path_cfgs)

        mesh = self.mesh
        split = self._tp_dim if compute else (lambda p: None)

        def whole_eff(prefix, st, gcfg, dims, n=None):
            # a class stack of n members per group: on this rank's rows
            sw = self._specs[f"{prefix}/W"]
            fn = lambda s: alg.effective_weight(s, gcfg)  # noqa: E731
            res = (None if n is None else
                   shd.shard_stacked_call(fn, mesh, n, st, axis=1))
            if res is None:
                return self._compute_gather(fn(st), sw, dims)
            rows = shd.stacked_rows(mesh, n, axis=1)
            return self._compute_gather(res, shd.P(None, rows[1], *sw[2:]),
                                        dims)

        eff = {}
        if isinstance(tiles, TileBank):
            pidx = dict(tiles.index)
            for cname, gnames in tiles.class_index:
                gcfg = _group_tile_cfg(tiles, gnames[0], self.cfg.tile)
                dims = [split(p) for g in gnames for p in pidx[g]]
                whole, kept = whole_eff(f"tiles/{cname}", tiles.classes[cname],
                                        gcfg, dims, len(pidx[gnames[0]]))
                for ci, g in enumerate(gnames):
                    for i, p in enumerate(pidx[g]):
                        eff[p] = self._compute_cut(whole[ci, i], split(p),
                                                   kept)
        else:
            for p, ts in tiles.items():
                whole, kept = whole_eff(f"tiles/{p}", ts, path_cfgs[p],
                                        [split(p)])
                eff[p] = self._compute_cut(whole, split(p), kept)
        return tree_map_with_path(
            lambda p, leaf: eff[p] if (leaf is None and p in eff) else leaf,
            params, keep_none=True)

    def _data_group(self):
        data_axes, dsize, _, _ = shd.mesh_axis_sizes(self.mesh)
        return (self.mesh.group(data_axes) if dsize > 1 else None), dsize

    # -- compute over the model axis (``tensor_parallel``) ------------------
    def _tp_dim(self, path: str) -> Optional[int]:
        """The dim (from the end) of ``path`` that the forward takes this
        rank's block of; None when it takes the whole weight."""
        return None if self.tp is None else self.tp.dim(path)

    def _model_axis(self):
        """(group, size, this rank's index) of the model axis."""
        _, _, model_ax, msize = shd.mesh_axis_sizes(self.mesh)
        return (self.mesh.group(model_ax), msize,
                self.mesh.index(model_ax))

    def _compute_gather(self, t, spec, dims):
        """``t`` (this rank's blocks under ``spec``) gathered over every
        sharded dim but one: the model axis's, when it is the dim that
        every member's forward splits (``dims``, each from the end or None)
        and so already this rank's compute block. Returns (tensor, the
        kept dim from the end or None)."""
        _, _, model_ax, _ = shd.mesh_axis_sizes(self.mesh)
        entries = shd._entries(spec, t.ndim)
        keep = None
        for d, e in enumerate(entries):
            if e == model_ax and all(m == d - t.ndim for m in dims):
                keep = d
        rest = shd.P(*[None if d == keep else e for d, e in enumerate(entries)])
        # "whole": a weight every member computes with whole (SSD's B/C at
        # one group, undivided K/V), which the model axis may store split
        tag = "weights" if any(m is not None for m in dims) else "whole"
        return (shd.gather(t, rest, self.mesh, tag=tag),
                None if keep is None else keep - t.ndim)

    def _compute_cut(self, t, dim, kept):
        """This rank's compute block of the weight ``t`` on ``dim`` (from
        the end; None: the whole weight), unless ``t`` is one already."""
        if dim is None or dim == kept:
            return t
        _, size, index = self._model_axis()
        n = t.shape[dim] // size
        return t.narrow(dim, index * n, n)

    def _compute_params(self, params):
        """The digital parameters the forward reads, from this rank's
        stored blocks: whole, or under ``tensor_parallel`` the split ones
        as this rank's compute blocks."""
        def view(p, t):
            dim = self._tp_dim(p)
            whole, kept = self._compute_gather(t, self._specs[f"params/{p}"],
                                               [dim])
            return self._compute_cut(whole, dim, kept)

        return tree_map_with_path(view, params)

    def _whole_grads(self, grads):
        """The gradients of the split parameters (this rank's blocks) made
        whole: their bytes in one all-gather over the model group, each
        block put back on its dim (a concatenation, exact)."""
        split = [(p, g) for p, g in flatten_with_path(grads)
                 if self._tp_dim(p) is not None]
        if not split:
            return grads
        group, size, _ = self._model_axis()
        buf = torch.cat([g.contiguous().reshape(-1).view(torch.uint8)
                         for _, g in split])
        rows = runtime.all_gather(buf, group, label="model/all_gather/grads")
        rows = rows.view(size, -1)
        whole, at = {}, 0
        for p, g in split:
            nb = g.numel() * g.element_size()
            blocks = [rows[r, at:at + nb].clone().view(g.dtype).view(g.shape)
                      for r in range(size)]
            whole[p] = torch.cat(blocks, dim=self._tp_dim(p))
            at += nb
        return tree_map_with_path(lambda p, g: whole.get(p, g), grads)

    def _local_batch(self, batch):
        """This rank's rows of the global batch; True when any leaf was
        split (the gradients are then averaged over the data axes). Under
        ``microbatch`` > 1 a rank holds its rows of every global microbatch,
        in microbatch order, so its microbatch i is its share of the one
        process's microbatch i."""
        sh = shd.batch_shardings(batch, self.mesh)
        cut = {p for p, s in flatten_with_path(sh)
               if len(s.spec) and s.spec[0] is not None}
        mb = self.cfg.microbatch
        if cut and mb > 1:
            _, dsize = self._data_group()

            def interleave(x):
                rows = x.shape[0]
                if rows % (mb * dsize):
                    raise ValueError(
                        f"a batch of {rows} rows does not split into "
                        f"{mb} microbatches over {dsize} data ranks")
                return x.reshape(mb, dsize, rows // (mb * dsize),
                                 *x.shape[1:]).transpose(0, 1).reshape(x.shape)

            batch = tree_map_with_path(
                lambda p, x: interleave(x) if p in cut else x, batch)
        return shd.shard_tree(batch, sh), bool(cut)

    def _mean_over_data(self, tensors):
        """The mean over the data axes of a list of tensors (one SUM
        all-reduce of a float32 buffer, then a true division by the data
        size); each result in its tensor's dtype."""
        group, dsize = self._data_group()
        if group is None or not tensors:
            return list(tensors)
        buf = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        buf = div(runtime.all_reduce(buf, group, label="grad_all_reduce"),
                  float(dsize))
        out, at = [], 0
        for t in tensors:
            out.append(buf[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def _apply_digital(self, params, grads, opt, step, lr,
                       inplace: bool = False):
        """``apply_opt`` under the mesh on this rank's stored ``params``
        blocks and the whole ``grads``: clipping on the whole gradients,
        the update on this rank's block of the moments (the parameter
        block cut over the moments' data dims), the new parameters
        gathered over those dims only. The update is element-wise, so the
        blocks are the one-process update's. ``inplace``: the moments are
        written in place and the gathered parameters into the stored
        blocks."""
        cfg = self.cfg.digital
        layout = self._layout()
        gnorm = torch.zeros((), dtype=torch.float32)
        if cfg.clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        cfg = dataclasses.replace(cfg, clip_norm=0.0)
        moments = layout["opt"].get("mu")
        if moments is None:
            new_params, new_opt, _ = apply_opt(
                params, shd.shard_tree(grads, layout["params"]), opt, step,
                lr, cfg, inplace)
            return new_params, new_opt, gnorm
        pspec = {p: s.spec for p, s in flatten_with_path(layout["params"])}
        mspec = {p: s.spec for p, s in flatten_with_path(moments)}

        def data_dims(p, nd):
            return [d for d, (a, b) in enumerate(zip(
                shd._entries(mspec[p], nd), shd._entries(pspec[p], nd)))
                if a != b]

        new_params, new_opt, _ = apply_opt(
            tree_map_with_path(lambda p, t: shd.shard(
                t, mspec[p], self.mesh, dims=data_dims(p, t.ndim)), params),
            shd.shard_tree(grads, moments), opt, step, lr, cfg, inplace)
        new_params = tree_map_with_path(lambda p, t: shd.gather(
            t, mspec[p], self.mesh, dims=data_dims(p, t.ndim)), new_params)
        if inplace:
            new_params = _write_back(params, new_params)
        return new_params, new_opt, gnorm

    # -- state ------------------------------------------------------------
    def init(self, key, params, sp_estimates: Optional[Dict[str, Any]] = None) -> TrainState:
        """Initial state. ``key`` is a host key (``prng.PRNGKey``); tiles
        live on the device of the parameter they map."""
        digital, analog, policies = plan_partition(params, self.plan)
        self._remember_path_cfgs(analog, policies)
        logger.info(self.describe_plan(params))
        per_tile = {}
        for p, w0 in sorted(analog.items()):
            sp = (sp_estimates or {}).get(p)
            per_tile[p] = init_tile(_crc_fold(key, p), w0,
                                    policies[p].tile or self.cfg.tile, sp)
        if self.cfg.engine == "grouped":
            index = group_tiles({p: tuple(w.shape) for p, w in analog.items()},
                                self.cfg.tile, policies)
            tiles = stack_tiles(per_tile, index,
                                group_policies(index, policies))
        else:
            tiles = per_tile
        state = TrainState(
            step=torch.zeros((), dtype=torch.int32),
            key=prng.key_data(key).clone(),
            params=digital,
            tiles=tiles,
            opt=init_opt(digital, self.cfg.digital),
        )
        # under a mesh every rank draws the whole state, then keeps its blocks
        return state if self.mesh is None else self.shard_state(state)

    def abstract_state(self, params_shapes, device="cuda") -> TrainState:
        """TensorSpec state on ``device`` (a restore template; allocates
        nothing). ``params_shapes`` is a tree of TensorSpecs or tensors;
        the step counter, key and tile seeds are host leaves, as ``init``
        makes them. The template is the whole state's; under a mesh it also
        sets ``self.shardings``, each rank's layout of it (pass both to
        ``checkpoint.ckpt.restore``)."""
        specs = tree_map(
            lambda leaf: TensorSpec(tuple(leaf.shape), leaf.dtype, device),
            params_shapes)
        digital, analog, policies = plan_partition(specs, self.plan)
        self._remember_path_cfgs(analog, policies)
        if self.cfg.engine == "grouped":
            index = group_tiles({p: w.shape for p, w in analog.items()},
                                self.cfg.tile, policies)
            pols = group_policies(index, policies)
            tiles = TileBank(
                {g: abstract_tile_group(
                    analog[paths[0]].shape, len(paths),
                    (pols or {}).get(g, TilePolicy(self.cfg.tile)).tile,
                    device)
                 for g, paths in index},
                index, pols)
        else:
            tiles = {p: abstract_tile(w.shape,
                                      policies[p].tile or self.cfg.tile, device)
                     for p, w in sorted(analog.items())}
        # init_opt on allocation-free meta tensors gives the opt structure
        meta = init_opt(tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                       device="meta"), digital),
                        self.cfg.digital)
        opt = tree_map(lambda m: TensorSpec(tuple(m.shape), m.dtype, device),
                       meta)
        template = TrainState(
            step=TensorSpec((), torch.int32, "cpu"),
            key=TensorSpec((2,), torch.int64, "cpu"),
            params=digital,
            tiles=tiles,
            opt=opt,
        )
        if self.mesh is not None:
            self._set_shardings(template)
        return template

    # -- step -------------------------------------------------------------
    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step; returns (new state, metrics) and leaves ``state`` as it
        was."""
        return self._step(state, batch, donate=False)

    def train_step_(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The donated step: ``train_step`` with every leaf of ``state``
        written in place; returns (``state``, metrics)."""
        return self._step(state, batch, donate=True)

    def _step(self, state: TrainState, batch, donate: bool):
        with span("train/step", lambda: str(int(state["step"]))):
            return self._phases(state, batch, donate)

    def _phases(self, state: TrainState, batch, donate: bool):
        key, k_begin, k_model, k_upd = prng.split(state["key"], 4)
        grouped = isinstance(state["tiles"], TileBank)
        path_cfgs = self._path_cfgs(state["tiles"])

        # phase 1: chopper / Q~ sync (under a mesh on the blocks as stored)
        with span("train/begin"):
            if grouped:
                tiles = self.begin_tiles(state["tiles"], k_begin, donate)
            else:
                tiles = {
                    p: alg.begin_step(ts, _crc_fold(k_begin, p), path_cfgs[p],
                                      donate)
                    for p, ts in sorted(state["tiles"].items())
                }

        # phase 2: forward/backward on effective weights (+ accumulation)
        loss, aux, grads = self.loss_and_grads(state["params"], tiles, batch,
                                               k_model)

        lr = lr_at(state["step"], self.cfg.schedule)

        # phase 3a: digital branch
        dgrads = mask_digital_grads(grads, tiles)
        with span("train/digital"):
            if self.mesh is None:
                new_params, new_opt, gnorm = apply_opt(
                    state["params"], dgrads, state["opt"], state["step"], lr,
                    self.cfg.digital, donate)
            else:
                new_params, new_opt, gnorm = self._apply_digital(
                    state["params"], dgrads, state["opt"], state["step"], lr,
                    donate)

        # phase 3b: analog branch (pulse updates)
        with span("train/update"):
            agrads = extract_analog_grads(grads, tiles)
            tile_metrics = []
            if grouped:
                pidx = dict(tiles.index)
                stacked_grads = {}
                for cname, gnames in tiles.class_index:
                    flat = [agrads[p] for g in gnames for p in pidx[g]]
                    cdims = (len(gnames), len(pidx[gnames[0]]))
                    arr = (torch.stack(flat) if len(flat) > 1
                           else flat[0].unsqueeze(0))
                    stacked_grads[cname] = arr.reshape(cdims
                                                       + tuple(flat[0].shape))
                new_tiles, tile_metrics = self.update_tiles(
                    tiles, stacked_grads, k_upd, lr, donate)
            else:
                new_tiles = {}
                for p, ts in sorted(tiles.items()):
                    ts2, m = self._looped_update(p, ts, agrads[p],
                                                 _crc_fold(k_upd, p),
                                                 path_cfgs[p], lr, donate)
                    new_tiles[p] = ts2
                    tile_metrics.append(m)

            metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, **aux}
            if tile_metrics:
                # mixed plans: aggregate each key over the groups that emit it
                keys = sorted({k for m in tile_metrics for k in m})
                for k in keys:
                    vals = torch.cat([torch.atleast_1d(m[k])
                                      for m in tile_metrics if k in m])
                    metrics[f"tile/{k}"] = (torch.sum(vals)
                                            if k in ("pulses", "prog_events")
                                            else torch.mean(vals))

        if donate:
            # every device leaf was written in place; the host leaves too
            state["step"].add_(1)
            state["key"].copy_(key)
            return state, metrics
        new_state = TrainState(
            step=state["step"] + 1,
            key=key,
            params=new_params,
            tiles=new_tiles,
            opt=new_opt,
        )
        return new_state, metrics

    def loss_and_grads(self, params, tiles, batch, key):
        """Phase 2 of the step: (loss, aux, whole gradients) of ``batch`` on
        the digital ``params`` and the effective weights of ``tiles`` (under
        a mesh: this rank's stored blocks of both), accumulated over
        ``cfg.microbatch``. Under a mesh, on this rank's rows of the batch,
        averaged over the data axes; under ``tensor_parallel``, on this
        rank's compute blocks, the split gradients then gathered whole."""
        path_cfgs = self._path_cfgs(tiles)
        split = False
        if self.mesh is not None:
            params = self._compute_params(params)
            batch, split = self._local_batch(batch)
        with span("train/merge"):
            eff = self._merged(params, tiles, path_cfgs, compute=True)
        del params
        if split or self.tp is not None:
            # batch statistics inside the model (the MoE router's) are the
            # global batch's, and the split modules meet over the model
            # axis; imported here, as models import the core
            from ..models.common import data_parallel, model_parallel

            group, dsize = self._data_group() if split else (None, 1)
            with data_parallel(group, dsize), model_parallel(
                    *(self._model_axis() if self.tp else (None, 1, 0))):
                loss, aux, grads = self._forward_backward(eff, batch, key)
        else:
            loss, aux, grads = self._forward_backward(eff, batch, key)
        del eff
        if split:
            flat = flatten_with_path(grads)
            akeys = [k for k in sorted(aux) if torch.is_tensor(aux[k])]
            reduced = self._mean_over_data(
                [loss] + [aux[k] for k in akeys] + [g for _, g in flat])
            loss = reduced[0]
            aux = {**aux, **dict(zip(akeys, reduced[1:1 + len(akeys)]))}
            by_path = dict(zip((p for p, _ in flat), reduced[1 + len(akeys):]))
            grads = tree_map_with_path(lambda p, _: by_path[p], grads)
        if self.tp is not None:
            grads = self._whole_grads(grads)
        return loss, aux, grads

    def _forward_backward(self, eff, batch, k_model):
        """(loss, aux, grads) of ``batch``, accumulated over
        ``cfg.microbatch`` slices of it."""
        with span("train/fwd_bwd"):
            mb = self.cfg.microbatch
            if mb <= 1:
                return _value_and_grad(self.loss_fn, eff, batch, k_model)

            def slice_batch(i):
                return tree_map(
                    lambda x: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                    if getattr(x, "ndim", 0) >= 1 else x, batch)

            loss, aux, grads = _value_and_grad(
                self.loss_fn, eff, slice_batch(0), prng.fold_in(k_model, 0))
            loss = loss.to(torch.float32)
            grads = tree_map(lambda g: g.to(self.cfg.accum_dtype), grads)
            for i in range(1, mb):
                l, a, g = _value_and_grad(self.loss_fn, eff, slice_batch(i),
                                          prng.fold_in(k_model, i))
                grads = tree_map(
                    lambda acc, gi: acc + gi.to(self.cfg.accum_dtype), grads, g)
                aux = {k: aux[k] + a[k] for k in aux}
                loss = loss + l
            inv = 1.0 / mb
            grads = tree_map(lambda g: g * inv, grads)
            loss = loss * inv
            aux = {k: v * inv for k, v in aux.items()}
            return loss, aux, grads

    def begin_tiles(self, bank: TileBank, key,
                    donate: bool = False) -> TileBank:
        """Phase 1 of the grouped engine: ``begin_step`` of every tile.
        ``donate``: written into ``bank``'s stacks, which it returns."""
        begun = self._grouped_apply(
            bank,
            lambda gcfg: _per_tile(
                lambda ts, k: alg.begin_step(ts, k, gcfg, donate), donate),
            key, members="local", inplace=donate)
        if donate:
            return bank
        return TileBank.from_classes(begun, bank.index, bank.class_index,
                                     bank.policies)

    def update_tiles(self, bank: TileBank, stacked_grads, key, lr,
                     donate: bool = False):
        """Phase 3b of the grouped engine: the pulse update of every tile
        from whole (C, n, *member) gradients per class. Returns the new
        bank (``donate``: ``bank``, written in place) and one
        {metric: (C*n,)} dict per class."""
        def make_update_vfn(gcfg):
            if gcfg.update_backend == "fused":
                return lambda ts, kr, grd: alg.update_batched(
                    ts, grd, kr, gcfg, lr, donate)
            return _per_tile(
                lambda ts, k, grd: alg.update(ts, grd, k, gcfg, lr, donate),
                donate)

        res = self._grouped_apply(bank, make_update_vfn, key,
                                  extras=(stacked_grads,), inplace=donate)
        new = bank if donate else TileBank.from_classes(
            {c: res[c][0] for c, _ in bank.class_index},
            bank.index, bank.class_index, bank.policies)
        return new, [{k: v.reshape(-1) for k, v in res[c][1].items()}
                     for c, _ in bank.class_index]

    def _looped_update(self, path, ts, grad, key, cfg, lr,
                       donate: bool = False):
        """One tile's update (looped engine); under a mesh on the whole
        tile, gathered, then cut back to this rank's blocks (``donate``:
        written into them)."""
        if self.mesh is None:
            return alg.update(ts, grad, key, cfg, lr, donate)

        spec = lambda p: self._specs[f"tiles/{path}/{p}"]  # noqa: E731
        whole = tree_map_with_path(
            lambda p, leaf: shd.gather(leaf, spec(p), self.mesh), ts)
        st, m = alg.update(whole, grad, key, cfg, lr, donate)
        st = tree_map_with_path(
            lambda p, leaf: shd.shard(leaf, spec(p), self.mesh), st)
        return (_write_back(ts, st) if donate else st), m

    def jit_step(self, donate: bool = True, **_):
        """The step to run (eager; nothing is compiled): ``train_step_``,
        which writes the state in place, as the reference's
        ``jit_step(donate=True)`` donates it, or ``train_step`` with
        ``donate=False``."""
        return self.train_step_ if donate else self.train_step
