"""Per-rank dry run on the ``meta`` device: one rank's step at a
production cell's shapes, accounted with no card and no process group.

Port of the JAX package's ``launch/dryrun.py``. The JAX module lowers and
compiles each (arch x shape x mesh) cell on 512 placeholder CPU devices
and reads XLA's memory and cost analyses. The port runs one process per
rank and has no compiler, so it accounts for one rank of the mesh (rank 0;
``--rank`` picks another):

* the parameters, the trainer state and the batch are built on ``meta``
  from the shapes and the specs of ``distributed/sharding.py`` (held
  element for element to the JAX package's): each leaf at its per-rank
  block shape; the host leaves (key, step counter, tile seeds) as small
  CPU tensors, as the trainer keeps them;
* for a **train** cell, that rank's step runs inside
  ``distributed.runtime.abstract`` (collectives only compute shapes and
  count their bytes) under ``roofline.op_cost.OpTrace``: it reports the
  argument bytes, the peak of live storage bytes over the trace (each
  storage rounded up to the caching allocator's 512 B), the flops, memory
  and collective bytes, and the ``Roofline`` on the H100's constants
  (``status "ok"``). The step is the one the CLI runs,
  ``trainer.jit_step()``: donated, its state written in place, as the
  reference lowers it with ``donate_argnums=(0,)``. ``account_step`` is
  that accounting alone, for any trainer and state;
* a **prefill** or **decode** cell builds that rank's blocks of the
  parameters (``params_shardings``) and of the fixed cache
  (``cache_shardings``) and its rows of the inputs, and runs
  ``LM.prefill`` or ``LM.serve_step`` (at the cache's last position) the
  same way, with the gathers of ``sharding.compute_params`` in the step:
  the weights cut where ``tp_layout`` cuts them, the cache met through
  ``sharding.CacheShards`` and written in place (the reference donates
  it). ``account_serve`` is that accounting alone. A cell whose batch
  does not split over the data axes (``long_500k``: one row) is computed
  by every data rank, as the reference's one program computes it: its
  caches split on their sequence or on their period axis are met through
  ``CacheShards`` too.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k [--multi-pod] [--rank R] [--out results/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from .. import api
from ..configs import ARCHS, SHAPES, get_config, input_specs, shape_applicable
from ..core.device import DeviceConfig
from ..core.digital_opt import DigitalOptConfig, ScheduleConfig
from ..core.paths import flatten_with_path, tree_map_with_path
from ..core.tile import TileConfig
from ..core.trainer import HOST_LEAVES, AnalogTrainer, TrainerConfig
from ..distributed import runtime, sharding
from ..models.common import set_shard_rules
from ..models.lm import LM
from ..roofline import analysis
from ..roofline.op_cost import OpTrace, analyze_trace
from .mesh import make_production_mesh
from .serve import mesh_axes

# the caching allocator's block: every allocation on the card rounds up
ALLOC_ROUND = 512

# LM-scale analog tile config: bf16 state, regenerated device params
# (store_device=False), E-RIDER by default (the paper's headline method).
LM_DEVICE = DeviceConfig(kind="softbounds", dw_min=1e-4, sigma_d2d=0.1,
                         sigma_pm=0.3, sigma_c2c=0.05)
LM_DEVICE_P = DeviceConfig(kind="softbounds", dw_min=1e-4, sigma_d2d=0.1,
                           sigma_pm=0.3, sigma_c2c=0.05,
                           ref_mean=0.1, ref_std=0.1)

# per-arch microbatch count for train_4k (global batch 256)
MICROBATCH = {
    "deepseek-v2-236b": 16,
    "mixtral-8x7b": 16,
    "recurrentgemma-9b": 16,
    "qwen3-14b": 16,
    "gemma3-4b": 8,
    "minicpm3-4b": 8,
    "mamba2-2.7b": 8,
    "qwen2-0.5b": 4,
    "qwen2-vl-2b": 4,
    "seamless-m4t-large-v2": 4,
}


def make_tile_cfg(algorithm: str = "erider") -> TileConfig:
    return TileConfig(
        algorithm=algorithm,
        device_p=LM_DEVICE_P,
        device_w=LM_DEVICE,
        state_dtype=torch.bfloat16,
        store_device=False,
        rng="hash",
        lr_p=0.5, lr_w=0.05, gamma=0.1, eta=0.5, chopper_p=0.05,
    )


def make_plan(algorithm: str = "erider") -> api.AnalogPlan:
    """LM-scale AnalogPlan. ``algorithm`` is a single name or a
    comma-separated ``pattern=algorithm`` mixed plan, parsed by
    ``api.plan_from_spec`` with the dry run's LM-scale TileConfigs."""
    return api.plan_from_spec(algorithm, make_tile_cfg)


def make_trainer(model: LM, arch: str, algorithm: str, dsize: int,
                 tile_engine: str = "grouped", mesh=None) -> AnalogTrainer:
    """The reference's dry-run trainer; on a mesh with a model axis its
    compute splits where ``sharding.tp_layout`` says, as the reference's
    sharded step splits it."""
    mb = MICROBATCH.get(arch, 2)
    mb = max(1, min(mb, 256 // dsize))
    tcfg = TrainerConfig(
        digital=DigitalOptConfig(kind="sgdm", clip_norm=0.0),
        schedule=ScheduleConfig(kind="cosine", base_lr=0.1, total_steps=10000),
        microbatch=mb,
        accum_dtype=torch.bfloat16,
        engine=tile_engine,
    )
    tp = (sharding.tp_layout(model.cfg, mesh)
          if mesh is not None and mesh.size > 1 else None)
    return AnalogTrainer(model.loss, tcfg, plan=make_plan(algorithm),
                         mesh=mesh, tensor_parallel=tp)


# perf-iteration options:
#   zero_tiles: bool -- ZeRO-shard tile state over the data axes
#   moe_impl: einsum | ragged -- dispatch implementation
#   remat: bool -- activation checkpointing of the layer-period loop
#   attn_chunk / microbatch / moe_group: overrides
DEFAULT_OPTS = dict(zero_tiles=True, moe_impl=None, remat=None,
                    attn_chunk=None, microbatch=None, moe_group=None,
                    mla_absorbed=None, tile_engine="grouped")


# --------------------------------------------------------------------------
# per-rank tensors on meta
# --------------------------------------------------------------------------

def _host(path: str) -> bool:
    return path.split("/")[-1] in HOST_LEAVES


def _local(shape, spec, mesh):
    if mesh is None or spec is None:
        return tuple(shape)
    return sharding.local_shape(tuple(shape), spec, mesh)


def rank_tree(specs, shardings=None, mesh=None):
    """Tensors for one rank from a tree of ``TensorSpec`` leaves: each leaf
    at its block shape under ``shardings`` (a tree of NamedShardings, or
    None: whole), the host leaves as zeros on the CPU, the rest as empty
    ``meta`` tensors."""
    spec_of = ({} if shardings is None else
               {p: s.spec for p, s in flatten_with_path(shardings)})

    def make(path, leaf):
        shape = _local(leaf.shape, spec_of.get(path), mesh)
        if _host(path) or torch.device(leaf.device).type == "cpu":
            return torch.zeros(shape, dtype=leaf.dtype)
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    return tree_map_with_path(make, specs)


def leaf_bytes(tree, shardings=None, mesh=None, device_only: bool = True,
               ) -> int:
    """Bytes of one rank's blocks of ``tree`` (TensorSpecs or tensors);
    ``device_only`` leaves out the host leaves (key, step, seeds)."""
    spec_of = ({} if shardings is None else
               {p: s.spec for p, s in flatten_with_path(shardings)})
    total = 0
    for p, leaf in flatten_with_path(tree):
        if device_only and _host(p):
            continue
        n = 1
        for d in _local(leaf.shape, spec_of.get(p), mesh):
            n *= d
        total += n * torch.empty((), dtype=leaf.dtype).element_size()
    return total


def _storage_bytes(tree, round_bytes: int) -> int:
    """Bytes of the distinct device storages in ``tree`` (host leaves and
    CPU tensors left out), each rounded up to ``round_bytes``."""
    seen = {}
    for _, t in flatten_with_path(tree):
        if not isinstance(t, torch.Tensor) or t.device.type == "cpu":
            continue
        st = t.untyped_storage()
        seen[st._cdata] = -(-st.nbytes() // round_bytes) * round_bytes
    return sum(seen.values())


def account_step(trainer: AnalogTrainer, state, batch, mesh=None,
                 rank: int = 0, round_bytes: int = ALLOC_ROUND,
                 donate: bool = True) -> Dict:
    """Run ``trainer.jit_step(donate)(state, batch)`` once under ``OpTrace``
    (inside ``runtime.abstract(mesh, rank)`` on a mesh of more than one
    rank) and account for it: ``argument_bytes`` (the distinct device
    storages of state and batch), ``temp_bytes`` (the peak of the storages
    the step made and still held), ``peak_bytes`` (their sum),
    ``tile_state_bytes`` (every leaf of ``state["tiles"]``, the host seeds
    included, as ``chip_smoke.py`` counts them), the ``cost`` and the
    ``trace``. On ``meta`` tensors nothing is allocated. The donated step
    (the default, the CLI's) writes ``state`` in place; ``donate=False``
    accounts for the out-of-place ``train_step``, which holds the old and
    the new state at once."""
    args = _storage_bytes((state, batch), round_bytes)
    tiles = sum(t.numel() * t.element_size()
                for _, t in flatten_with_path(state["tiles"]))
    ctx = (runtime.abstract(mesh, rank)
           if mesh is not None and mesh.size > 1 else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx, OpTrace(round_bytes=round_bytes) as tr:
        new_state, metrics = trainer.jit_step(donate)(state, batch)
    seconds = time.perf_counter() - t0
    del new_state, metrics
    return dict(argument_bytes=args, temp_bytes=tr.peak_bytes,
                peak_bytes=args + tr.peak_bytes, tile_state_bytes=tiles,
                cost=analyze_trace(tr), trace=tr, trace_s=seconds)


def account_serve(model: LM, params, cache, inputs, *, kind: str, pos: int = 0,
                  mesh=None, rank: int = 0, shardings=None, layout=None,
                  shards=None, round_bytes: int = ALLOC_ROUND) -> Dict:
    """Run one ``model.prefill(params, inputs, cache)`` (``kind``
    "prefill") or ``model.serve_step(params, inputs["tokens"], cache,
    pos)`` under ``OpTrace`` and account for it as ``account_step`` does.
    On a mesh of more than one rank, as rank ``rank`` inside
    ``runtime.abstract``: ``params`` are its ``shardings``
    (``params_shardings``) blocks, made the weights it computes with by
    ``sharding.compute_params`` under ``layout`` (a ``tp_layout``) inside
    the trace, and ``cache`` its blocks, met through ``shards`` (a
    ``sharding.CacheShards``). The cache is written in place, so the
    step's own bytes are its transients."""
    args = _storage_bytes((params, cache, inputs), round_bytes)
    split = mesh is not None and mesh.size > 1
    ctx = runtime.abstract(mesh, rank) if split else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx, OpTrace(round_bytes=round_bytes) as tr:
        with mesh_axes(mesh if split else None,
                       shards.batch if split else 0):
            w = (sharding.compute_params(params, shardings, layout)
                 if split else params)
            if kind == "prefill":
                out = model.prefill(w, inputs, cache, shards)
            else:
                out = model.serve_step(w, inputs["tokens"], cache, pos,
                                       shards)
            del w, out
    seconds = time.perf_counter() - t0
    return dict(argument_bytes=args, temp_bytes=tr.peak_bytes,
                peak_bytes=args + tr.peak_bytes, cost=analyze_trace(tr),
                trace=tr, trace_s=seconds)


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    kind: str                 # train | prefill | decode
    model_flops: float
    plan_line: Optional[str]
    argument_bytes: int       # one rank's device argument bytes
    trainer: Optional[AnalogTrainer] = None
    state: object = None
    batch: object = None
    serve: Optional[Dict] = None   # account_serve's arguments


def build_cell(arch: str, shape_name: str, mesh, *, algorithm: str = "erider",
               opts=None, build_state: bool = True) -> Cell:
    """One cell on ``mesh`` for one rank: the trainer, that rank's state
    (``meta``) and the global batch for a train cell; that rank's blocks
    of the parameters, the cache and the inputs for a serve cell; the
    argument bytes of every cell. ``build_state=False`` stops at the
    bytes."""
    o = dict(DEFAULT_OPTS, **(opts or {}))
    cfg = get_config(arch)
    over = {k: o[k] for k in ("moe_impl", "remat", "attn_chunk", "moe_group",
                              "mla_absorbed") if o[k] is not None}
    if over:
        cfg = dataclasses.replace(cfg, **over)
    spec = SHAPES[shape_name]
    model = LM(cfg)
    aparams = model.abstract_params("meta")
    _, dsize, _, msize = sharding.mesh_axis_sizes(mesh)
    batch_specs = input_specs(cfg, shape_name, device="meta")
    mflops = analysis.model_flops_for(cfg, spec)
    b_sh = sharding.batch_shardings(batch_specs, mesh)

    if spec.kind == "train":
        trainer = make_trainer(model, arch, algorithm, dsize,
                               tile_engine=o["tile_engine"],
                               mesh=mesh if mesh.size > 1 else None)
        if o["microbatch"] is not None:
            trainer.cfg = dataclasses.replace(trainer.cfg,
                                              microbatch=o["microbatch"])
        astate = trainer.abstract_state(aparams, "meta")
        st_sh = sharding.state_shardings(astate, mesh,
                                         zero_states=o["zero_tiles"])
        if trainer.mesh is not None:
            trainer.shardings = st_sh
            trainer._specs = {p: s.spec for p, s in flatten_with_path(st_sh)}
        nbytes = (leaf_bytes(astate, st_sh, mesh)
                  + leaf_bytes(batch_specs, b_sh, mesh))
        cell = Cell("train", mflops, trainer.describe_plan(aparams), nbytes,
                    trainer)
        if build_state:
            cell.state = rank_tree(astate, st_sh, mesh)
            cell.batch = rank_tree(batch_specs)   # global: the step cuts it
        return cell

    p_sh = sharding.params_shardings(aparams, mesh)
    if spec.kind == "prefill":
        enc_len = spec.seq_len if cfg.is_encdec else 0
        inputs = batch_specs
    else:
        enc_len = min(spec.seq_len, 32768) if cfg.is_encdec else 0
        inputs = {"t": batch_specs["tokens"], "pos": batch_specs["pos"]}
    acache = model.init_cache(spec.global_batch, spec.seq_len,
                              enc_len=enc_len, abstract=True, device="meta")
    c_sh = sharding.cache_shardings(acache, mesh)
    in_sh = sharding.batch_shardings(inputs, mesh)
    if spec.kind == "decode":
        # the position is replicated, as the reference passes it
        in_sh["pos"] = sharding.NamedSharding(mesh, sharding.P())
    nbytes = (leaf_bytes(aparams, p_sh, mesh) + leaf_bytes(acache, c_sh, mesh)
              + leaf_bytes(inputs, in_sh, mesh))
    cell = Cell(spec.kind, mflops, None, nbytes)
    if build_state:
        feed = ({"tokens": inputs["t"]} if spec.kind == "decode"
                else dict(inputs))
        f_sh = sharding.batch_shardings(feed, mesh)
        cell.serve = dict(
            model=model, params=rank_tree(aparams, p_sh, mesh),
            cache=rank_tree(acache, c_sh, mesh),
            inputs=rank_tree(feed, f_sh, mesh), kind=spec.kind,
            pos=spec.seq_len - 1, shardings=p_sh,
            layout=sharding.tp_layout(cfg, mesh) if msize > 1 else None,
            shards=sharding.CacheShards(c_sh, spec.global_batch))
    return cell


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             algorithm: str = "erider", tag: str = "", opts=None,
             rank: int = 0) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell_id + ".json")

    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
              "rank": rank,
              "opts": {k: v for k, v in (opts or {}).items() if v is not None}}
    if not ok:
        result.update(status="skipped", reason=reason)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"[dryrun] {cell_id}: SKIPPED ({reason})", flush=True)
        return result

    mesh = make_production_mesh(multi_pod=multi_pod)
    set_shard_rules(sharding.logical_rules(mesh))
    chips = mesh.size
    try:
        t0 = time.time()
        cell = build_cell(arch, shape_name, mesh, algorithm=algorithm,
                          opts=opts)
        t_build = time.time() - t0
        if cell.plan_line:
            result["plan"] = cell.plan_line
            print(f"[dryrun] {cell_id}: {cell.plan_line}", flush=True)
        if cell.kind == "train":
            acc = account_step(cell.trainer, cell.state, cell.batch,
                               cell.trainer.mesh, rank)
        else:
            acc = account_serve(**cell.serve, mesh=mesh, rank=rank)
        roof = analysis.analyze(
            arch=arch, shape=shape_name, mesh_name=mesh_name,
            chips=chips, cost=acc["cost"], model_flops=cell.model_flops,
            peak_bytes=acc["peak_bytes"],
            args_bytes=cell.argument_bytes)
        tr = acc["trace"]
        memory = dict(
            argument_bytes=cell.argument_bytes,
            argument_storage_bytes=acc["argument_bytes"],
            temp_bytes=acc["temp_bytes"],
            peak_bytes=acc["peak_bytes"],
            peak_per_device_gb=round(acc["peak_bytes"] / 2 ** 30, 3))
        if "tile_state_bytes" in acc:
            memory["tile_state_bytes"] = acc["tile_state_bytes"]
        result.update(
            status="ok", build_s=round(t_build, 1),
            trace_s=round(acc["trace_s"], 1), ops=len(tr.records),
            k1_records=len(tr.kernel_records("analog_update")),
            memory=memory,
            collectives={k: int(v) for k, v in tr.collectives.items()},
            roofline=roof.to_json(),
        )
        print(f"[dryrun] {cell_id}: OK trace={acc['trace_s']:.0f}s "
              f"mem/dev={result['memory']['peak_per_device_gb']}GB "
              f"bottleneck={roof.bottleneck} "
              f"frac={roof.roofline_fraction:.3f}", flush=True)
    except Exception as e:  # noqa: BLE001 -- report and continue the sweep
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {cell_id}: ERROR {type(e).__name__}: {str(e)[:200]}",
              flush=True)
    finally:
        set_shard_rules(None)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="full 40-cell sweep")
    ap.add_argument("--algorithm", default="erider")
    ap.add_argument("--tag", default="", help="suffix for perf-iteration runs")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh to account for")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-zero-tiles", action="store_true")
    ap.add_argument("--moe-impl", default=None, choices=[None, "einsum", "ragged"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--moe-group", type=int, default=None)
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--tile-engine", default="grouped",
                    choices=["grouped", "looped"],
                    help="looped = legacy per-tile update loop (baseline)")
    args = ap.parse_args(argv)
    opts = dict(zero_tiles=not args.no_zero_tiles, moe_impl=args.moe_impl,
                remat=False if args.no_remat else None,
                attn_chunk=args.attn_chunk, microbatch=args.microbatch,
                moe_group=args.moe_group,
                mla_absorbed=True if args.mla_absorbed else None,
                tile_engine=args.tile_engine)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else sorted(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                cell = f"{arch}__{shape}__{mesh_name}" + (f"__{args.tag}" if args.tag else "")
                path = os.path.join(args.out, cell + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[dryrun] {cell}: cached", flush=True)
                            continue
                run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                         algorithm=args.algorithm, tag=args.tag, opts=opts,
                         rank=args.rank)


if __name__ == "__main__":
    main()
