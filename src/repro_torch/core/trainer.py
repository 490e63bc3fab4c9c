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
update over each whole class stack (one 3-D kernel launch per array). A
loop over classes takes the place of ``lax.scan``, so ``scan_groups`` has
no effect on results here. ``engine="looped"`` keeps the per-tile dict
layout. Keys fold a CRC of the tile path or of the group's member paths,
as in the JAX package, so both packages draw the same bits.

PyTorch runs eagerly: ``jit_step()`` returns ``train_step`` itself. The
state's step counter and key stay on the host; tile state lives on the
parameters' device.
"""
from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import prng
from . import algorithms as alg
from .digital_opt import DigitalOptConfig, ScheduleConfig, apply_opt, init_opt, lr_at
from .paths import TensorSpec, flatten_with_path, tree_map, tree_map_with_path
from .plan import AnalogPlan, TilePolicy, legacy_plan, plan_partition
from .tile import (TileBank, TileConfig, _class_member, abstract_tile,
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


def _per_tile(fn):
    """Lift a per-tile ``fn(tile_state, key, *extras)`` to one group stack:
    a loop over the members, each with its own raw (2,) key, results
    restacked along a new leading axis."""
    def run(gstate, keys_raw, *extras):
        n = keys_raw.shape[0]
        outs = [fn(tree_map(lambda l, i=i: l[i], gstate), keys_raw[i],
                   *(tree_map(lambda l, i=i: l[i], e) for e in extras))
                for i in range(n)]
        return tree_map(lambda *ls: torch.stack(ls), *outs)
    return run


class AnalogTrainer:
    def __init__(self, loss_fn, cfg: TrainerConfig,
                 analog_filter: Optional[PathPredicate] = None, mesh=None, *,
                 plan: Optional[AnalogPlan] = None):
        """``plan``: an AnalogPlan mapping parameter paths to TilePolicies;
        when omitted, ``(cfg.tile, analog_filter)`` maps onto a one-rule
        plan behind a one-time DeprecationWarning. ``mesh`` is not
        supported yet (the distributed slice of the port)."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported yet; the port trains on one device")
        self.loss_fn = loss_fn
        self.cfg = cfg
        if plan is None:
            plan = legacy_plan(cfg.tile, analog_filter or default_analog_filter)
        elif analog_filter is not None:
            raise ValueError("pass either plan= or analog_filter=, not both")
        self.plan = plan
        self.analog_filter = analog_filter
        self.mesh = None
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

    def _grouped_apply(self, bank: TileBank, make_vfn, key, extras=()):
        """Apply one stack-level function per class.

        ``make_vfn(tcfg)`` returns ``vfn(group_state, keys_raw, *extra)``
        over one (n, *member) group stack. Per-group keys fold a CRC of the
        group's member paths. Classes under ``update_backend='fused'`` run
        as one flattened (C*n, *member) stack; other classes run group by
        group. Returns {class-name: vfn output with a leading class axis}.
        """
        index = dict(bank.index)

        def keys_raw(paths):
            return prng.split(_crc_fold(key, "|".join(paths)), len(paths))

        out = {}
        for cname, gnames in bank.class_index:
            tcfg = _group_tile_cfg(bank, gnames[0], self.cfg.tile)
            vfn = make_vfn(tcfg)
            cstate = bank.classes[cname]
            n_c = len(gnames)
            if tcfg.update_backend == "fused":
                kr = torch.cat([keys_raw(index[g]) for g in gnames])

                def flat(t):
                    return tree_map(
                        lambda l: l.reshape((-1,) + tuple(l.shape[2:])), t)

                res = vfn(flat(cstate), kr, *(flat(e[cname]) for e in extras))
                out[cname] = tree_map(
                    lambda l: l.reshape((n_c, l.shape[0] // n_c)
                                        + tuple(l.shape[1:])), res)
            else:
                results = [
                    vfn(_class_member(cstate, ci), keys_raw(index[g]),
                        *(_class_member(e[cname], ci) for e in extras))
                    for ci, g in enumerate(gnames)]
                out[cname] = (tree_map(lambda l: l.unsqueeze(0), results[0])
                              if n_c == 1 else
                              tree_map(lambda *ls: torch.stack(ls), *results))
        return out

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
        return TrainState(
            step=torch.zeros((), dtype=torch.int32),
            key=prng.key_data(key).clone(),
            params=digital,
            tiles=tiles,
            opt=init_opt(digital, self.cfg.digital),
        )

    def abstract_state(self, params_shapes, device="cuda") -> TrainState:
        """TensorSpec state on ``device`` (a restore template; allocates
        nothing). ``params_shapes`` is a tree of TensorSpecs or tensors;
        the step counter, key and tile seeds are host leaves, as ``init``
        makes them."""
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
        return TrainState(
            step=TensorSpec((), torch.int32, "cpu"),
            key=TensorSpec((2,), torch.int64, "cpu"),
            params=digital,
            tiles=tiles,
            opt=opt,
        )

    # -- step -------------------------------------------------------------
    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        tcfg = self.cfg.tile
        key, k_begin, k_model, k_upd = prng.split(state["key"], 4)
        grouped = isinstance(state["tiles"], TileBank)

        # phase 1: chopper / Q~ sync
        if grouped:
            bank: TileBank = state["tiles"]
            begun = self._grouped_apply(
                bank,
                lambda gcfg: _per_tile(
                    lambda ts, k: alg.begin_step(ts, k, gcfg)),
                k_begin)
            tiles = TileBank.from_classes(begun, bank.index, bank.class_index,
                                          bank.policies)
            path_cfgs = None
        else:
            path_cfgs = {p: self._tile_cfg_of(p) for p in state["tiles"]}
            tiles = {
                p: alg.begin_step(ts, _crc_fold(k_begin, p), path_cfgs[p])
                for p, ts in sorted(state["tiles"].items())
            }

        # phase 2: forward/backward on effective weights (+ accumulation)
        eff = merge_effective(state["params"], tiles, tcfg, path_cfgs)
        mb = self.cfg.microbatch
        if mb <= 1:
            loss, aux, grads = _value_and_grad(self.loss_fn, eff, batch, k_model)
        else:
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
                grads = tree_map(lambda acc, gi: acc + gi.to(self.cfg.accum_dtype),
                                 grads, g)
                aux = {k: aux[k] + a[k] for k in aux}
                loss = loss + l
            inv = 1.0 / mb
            grads = tree_map(lambda g: g * inv, grads)
            loss = loss * inv
            aux = {k: v * inv for k, v in aux.items()}

        lr = lr_at(state["step"], self.cfg.schedule)

        # phase 3a: digital branch
        dgrads = mask_digital_grads(grads, tiles)
        new_params, new_opt, gnorm = apply_opt(
            state["params"], dgrads, state["opt"], state["step"], lr,
            self.cfg.digital)

        # phase 3b: analog branch (pulse updates)
        agrads = extract_analog_grads(grads, tiles)
        tile_metrics = []
        if grouped:
            pidx = dict(tiles.index)
            stacked_grads = {}
            for cname, gnames in tiles.class_index:
                flat = [agrads[p] for g in gnames for p in pidx[g]]
                cdims = tuple(tiles.classes[cname]["W"].shape[:2])
                arr = torch.stack(flat) if len(flat) > 1 else flat[0].unsqueeze(0)
                stacked_grads[cname] = arr.reshape(cdims + tuple(flat[0].shape))

            def make_update_vfn(gcfg):
                if gcfg.update_backend == "fused":
                    return lambda ts, kr, grd: alg.update_batched(
                        ts, grd, kr, gcfg, lr)
                return _per_tile(
                    lambda ts, k, grd: alg.update(ts, grd, k, gcfg, lr))

            res = self._grouped_apply(
                tiles, make_update_vfn, k_upd, extras=(stacked_grads,))
            new_tiles = TileBank.from_classes(
                {c: res[c][0] for c, _ in tiles.class_index},
                tiles.index, tiles.class_index, tiles.policies)
            tile_metrics = [{k: v.reshape(-1) for k, v in res[c][1].items()}
                            for c, _ in tiles.class_index]
        else:
            new_tiles = {}
            for p, ts in sorted(tiles.items()):
                ts2, m = alg.update(ts, agrads[p], _crc_fold(k_upd, p),
                                    path_cfgs[p], lr)
                new_tiles[p] = ts2
                tile_metrics.append(m)

        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, **aux}
        if tile_metrics:
            # mixed plans: aggregate each key over the groups that emit it
            keys = sorted({k for m in tile_metrics for k in m})
            for k in keys:
                vals = torch.cat([torch.atleast_1d(m[k]) for m in tile_metrics
                                  if k in m])
                metrics[f"tile/{k}"] = (torch.sum(vals)
                                        if k in ("pulses", "prog_events")
                                        else torch.mean(vals))

        new_state = TrainState(
            step=state["step"] + 1,
            key=key,
            params=new_params,
            tiles=new_tiles,
            opt=new_opt,
        )
        return new_state, metrics

    def jit_step(self, donate: bool = True, **_):
        """The eager step (PyTorch has no jit here; ``donate`` is moot)."""
        return self.train_step
