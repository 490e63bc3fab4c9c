"""Training CLI: analog LM training with checkpoint/restart, fault
tolerance and the data pipeline.

Port of the JAX package's ``launch/train.py``, with the same flags and the
same ``[train] ...`` lines, plus
  ``--device``      default ``cuda``; ``cpu`` runs the kernels' plain versions;
  ``--tiles``       the tile config: ``smoke`` is float32 state, threefry
                    noise and stored device parameters; ``full`` is bfloat16
                    state, hash noise and device parameters redrawn from seeds
                    each step; the default follows ``--smoke``;
  ``--data-vocab``  the token ids of the synthetic bigram stream (default:
                    the model's vocab). ``BigramLM`` draws a (V, V) float64
                    table, 185 GB at Qwen2's 151936 ids, so a full-width run
                    takes a smaller stream (8192 ids: 0.5 GB).

``--data-parallel D --model-parallel M`` trains on the (D, M) mesh of
``launch.mesh.make_host_mesh``, one rank per process: under torchrun (the
ranks' environment starts the process group), or in ranks whose caller
started it (``distributed.runtime.init(rank, world, init_file)``) before
``main``. The process group's world size must be D x M. Every rank draws
the global ``--batch`` and trains on its rows of it; rank 0 logs and writes
the checkpoints, which every rank gathers. The M ranks of a model group
split the compute where ``sharding.tp_layout`` says (printed once): the
heads of dense attention, cross-attention, MLA and SSD, the RG-LRU's gate
blocks, the MLP's and the experts' hidden units and the vocabulary; the
rest (MLA's latents, SSD's B/C at one group, norms) runs replicated.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 10 --data-parallel 2 --device cpu

``--algorithm`` takes either a single algorithm name (one policy on every
analog leaf) or a comma-separated mixed plan of ``pattern=algorithm`` rules
matched in order (globs, ``re:`` regexes, or bare substrings;
``digital`` is a valid algorithm):

  --algorithm erider
  --algorithm "attn=rider,**=erider"

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 100 --algorithm erider --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from .. import api, prng
from ..checkpoint import ckpt
from ..configs import ARCHS, get_config
from ..core.device import DeviceConfig
from ..core.digital_opt import DigitalOptConfig, ScheduleConfig
from ..core.tile import TileConfig
from ..core.trainer import AnalogTrainer, TrainerConfig
from ..data import BigramLM, Prefetcher
from ..distributed import runtime
from ..distributed.fault import PreemptionHandler, StragglerMonitor
from ..distributed.sharding import logical_rules, tp_layout
from ..lifetime import gdc
from ..models.common import set_shard_rules
from ..models.lm import LM
from .mesh import make_host_mesh


def make_tile_cfg(algorithm: str, smoke: bool) -> TileConfig:
    # device_w carries PCM-grade lifetime coefficients (drift_nu ~ 0.06,
    # cf. the pcm_gst preset): checkpoints trained by this CLI can be
    # aged and drift-compensated by repro_torch.lifetime.
    dev = DeviceConfig(kind="softbounds", dw_min=2e-4 if smoke else 1e-4,
                       sigma_d2d=0.1, sigma_pm=0.3, sigma_c2c=0.05,
                       drift_nu=0.06, drift_nu_std=0.02, drift_t0=20.0,
                       prog_noise=0.01, prog_noise_slope=0.07, prog_rounds=3,
                       read_noise=0.005)
    dev_p = DeviceConfig(kind="softbounds", dw_min=2e-4 if smoke else 1e-4,
                         sigma_d2d=0.1, sigma_pm=0.3, sigma_c2c=0.05,
                         ref_mean=0.1, ref_std=0.1)
    return TileConfig(
        algorithm=algorithm, device_p=dev_p, device_w=dev,
        state_dtype=torch.float32 if smoke else torch.bfloat16,
        store_device=smoke, rng="threefry" if smoke else "hash",
        lr_p=0.5, lr_w=0.05, gamma=0.1, eta=0.5, chopper_p=0.05,
    )


def make_plan(algorithm: str, smoke: bool) -> api.AnalogPlan:
    """CLI ``--algorithm`` value -> AnalogPlan (see api.plan_from_spec)."""
    return api.plan_from_spec(algorithm, lambda a: make_tile_cfg(a, smoke))


def make_trainer(model: LM, algorithm: str, smoke: bool, steps: int,
                 lr: float = 0.1, mesh=None) -> AnalogTrainer:
    """The CLI's trainer: SGD-momentum with clipping on the digital leaves,
    a warm-up cosine schedule over ``steps``, the ``--algorithm`` plan;
    on a mesh with a model axis, compute split over it by
    ``sharding.tp_layout``."""
    tcfg = TrainerConfig(
        digital=DigitalOptConfig(kind="sgdm", clip_norm=1.0),
        schedule=ScheduleConfig(kind="cosine", base_lr=lr, total_steps=steps,
                                warmup_steps=min(20, steps // 5)),
    )
    tp = tp_layout(model.cfg, mesh) if mesh is not None else None
    return AnalogTrainer(model.loss, tcfg, plan=make_plan(algorithm, smoke),
                         mesh=mesh, tensor_parallel=tp)


def ckpt_extra(trainer, state) -> dict:
    """Extra manifest keys for ``ckpt.save``: the GDC t0 signatures of the
    effective analog weights (``repro_torch.lifetime.gdc``), over the
    merged tree the serve side rebuilds, so an unaged restore on the same
    device reproduces every signature bit for bit. Collective under a
    mesh."""
    tiles = state["tiles"]
    if not hasattr(tiles, "index"):
        return {}
    paths = [p for g, ps in tiles.index
             for p in ps
             if not (tiles.policy(g) is not None and tiles.policy(g).is_digital)]
    if not paths:
        return {}
    eff = trainer.effective_params(state)
    return {"gdc_signatures": {
        p: float(v) for p, v in gdc.signature_tree(eff, sorted(paths)).items()}}


def main(argv=None):
    """Train; returns ``(state, history)``, the final train state and the
    logged metrics, for callers that drive the CLI in process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--algorithm", default="erider")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", choices=("smoke", "full"), default=None,
                    help="tile config (default: smoke with --smoke)")
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="token ids of the bigram stream (default: the "
                         "model's vocab; its table takes 8 * V^2 host bytes)")
    args = ap.parse_args(argv)
    mesh = make_host_mesh(args.data_parallel, args.model_parallel)
    if mesh.size > 1:
        if not dist.is_initialized() and "RANK" in os.environ:
            runtime.init(device=args.device)    # torchrun's environment
        if runtime.world() != mesh.size:
            raise ValueError(
                f"--data-parallel {args.data_parallel} x --model-parallel "
                f"{args.model_parallel} is a mesh of {mesh.size} ranks, but "
                f"the process group has world size {runtime.world()}")
        set_shard_rules(logical_rules(mesh))
    else:
        mesh = None
    lead = runtime.rank() == 0
    device = torch.device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    data_vocab = args.data_vocab or cfg.vocab
    if not 0 < data_vocab <= cfg.vocab:
        raise ValueError(f"--data-vocab {data_vocab} outside (0, {cfg.vocab}]")
    model = LM(cfg)
    smoke_tiles = args.smoke if args.tiles is None else args.tiles == "smoke"
    trainer = make_trainer(model, args.algorithm, smoke_tiles, args.steps,
                           args.lr, mesh)
    log = print if lead else (lambda *a, **k: None)

    params = model.init(prng.PRNGKey(0), device)
    log(f"[train] {trainer.describe_plan(params)}", flush=True)
    if trainer.tp is not None:
        for line in trainer.tp.summary().splitlines():
            log(f"[train] {line}", flush=True)
    state = trainer.init(prng.PRNGKey(1), params)
    del params

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        if mesh is None:
            state = ckpt.restore(state, args.ckpt_dir)
        else:
            # every rank reads the whole arrays and keeps its blocks
            template = trainer.abstract_state(model.abstract_params(device),
                                              device)
            state = ckpt.restore(template, args.ckpt_dir,
                                 shardings=trainer.shardings)
        start_step = int(state["step"])
        log(f"[train] restored checkpoint at step {start_step}")

    data = BigramLM(vocab=data_vocab, seed=7)
    prefetch = Prefetcher(
        lambda s: data.batch(s, args.batch, args.seq), start_step=start_step,
        device=device)

    step_fn = trainer.jit_step()
    preempt = PreemptionHandler()
    monitor = StragglerMonitor()
    history = []
    pending = None

    try:
        it = iter(prefetch)
        for step in range(start_step, args.steps):
            batch = next(it)
            t0 = time.perf_counter()
            monitor.start()
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                # the monitor times the step the card ran, not its dispatch
                torch.cuda.synchronize(device)
            straggler = monitor.stop()
            step_s = time.perf_counter() - t0
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["straggler"] = bool(straggler)
                m["step_s"] = step_s
                history.append(m)
                log(f"[train] step={step} loss={m['loss']:.4f} "
                    f"acc={m.get('accuracy', 0):.3f} "
                    f"sp_err={m.get('tile/sp_err', -1):.4f} "
                    f"ema_s={monitor.ema:.3f}", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                pending = ckpt.save(state, args.ckpt_dir, step + 1,
                                    asynchronous=True,
                                    extra=ckpt_extra(trainer, state),
                                    shardings=trainer.shardings)
            if _any_rank(preempt.should_stop, mesh):
                log("[train] preemption signal — checkpointing and exiting")
                if args.ckpt_dir:
                    ckpt.save(state, args.ckpt_dir, step + 1,
                              extra=ckpt_extra(trainer, state),
                              shardings=trainer.shardings)
                break
    finally:
        prefetch.close()
    if args.ckpt_dir:
        if pending is not None:
            pending.join(timeout=60)
        ckpt.save(state, args.ckpt_dir, int(state["step"]),
                  extra=ckpt_extra(trainer, state),
                  shardings=trainer.shardings)
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    log(f"[train] done; stragglers flagged: {monitor.flagged}")
    return state, history


def _any_rank(flag: bool, mesh) -> bool:
    """``flag`` on any rank (one MAX all-reduce under a mesh, so every rank
    leaves the loop at the same step)."""
    if mesh is None:
        return flag
    return bool(runtime.all_reduce(torch.tensor([int(flag)]),
                                   dist.group.WORLD, op="max")[0])


if __name__ == "__main__":
    main()
