"""Where one training step of the PyTorch port spends its time on the card.

Runs the paper's FCN step (``repro_torch.benchmarks.common``), or with
``--model lm`` the training CLI's step on one LM at full width (``--arch``,
default Qwen2-0.5B; ``--layers N`` cuts the depth to N layers, as
``chip_smoke.py`` phase 11 cuts minicpm3-4b and mamba2-2.7b to 8) at batch
8 and ``--seq`` (default 128), E-RIDER, bf16 tiles with hash noise, the
bigram stream over 8192 ids, as ``chip_smoke.py`` phases 10 and 11 train
it, for a few warm-up steps, then ``--steps`` steps under
``torch.profiler``, and prints:
  * the wall time per step (host clock around steps that end in a
    synchronize; profiler on, so a little above the untraced time),
  * device busy time per step (sum of the CUDA kernels' device time) and
    the idle share of the wall time,
  * kernel launches per step, the pulse-update kernel's share (any of its
    modes), the hash normal and hash device kernels' (with their launches
    a step), the peak allocated memory, and the top kernels by device
    time.

Run on the card:  PYTHONPATH=src python -m repro_torch.benchmarks.step_profile \
                      --backend fused --steps 10
                  PYTHONPATH=src python -m repro_torch.benchmarks.step_profile \
                      --model lm --warmup 1 --steps 2
                  PYTHONPATH=src python -m repro_torch.benchmarks.step_profile \
                      --model lm --arch mamba2-2.7b --layers 8 --seq 512
"""
from __future__ import annotations

import argparse
import time


def cut_depth(cfg, layers: int):
    """``cfg`` with its depth cut to ``layers`` (0: as it is). Only a stack
    of one repeated period and no prefix or tail is cut, by its periods."""
    import dataclasses

    if not layers or layers == cfg.n_layers:
        return cfg
    if cfg.tail or cfg.first_dense_layers or layers % len(cfg.pattern):
        raise ValueError(f"cannot cut {cfg.name} to {layers} layers")
    return dataclasses.replace(cfg, n_layers=layers,
                               n_periods=layers // len(cfg.pattern))


def lm_run(backend: str, steps: int, arch: str = "qwen2-0.5b",
           layers: int = 0, seq: int = 128):
    """The training CLI's trainer, state and batches (on the card) for
    ``arch`` at full width (depth cut to ``layers``), E-RIDER under
    ``update_backend=backend``."""
    import dataclasses

    import torch

    from .. import api, prng
    from ..configs import get_config
    from ..core.trainer import AnalogTrainer
    from ..data import BigramLM
    from ..launch import train
    from ..models.lm import LM

    model = LM(cut_depth(get_config(arch), layers))
    cli = train.make_trainer(model, "erider", False, steps)
    plan = api.plan_from_spec("erider", lambda a: dataclasses.replace(
        train.make_tile_cfg(a, False), update_backend=backend))
    trainer = AnalogTrainer(model.loss, cli.cfg, plan=plan)
    state = trainer.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), "cuda"))
    data = BigramLM(vocab=8192, seed=7)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in data.batch(s, 8, seq).items()}
               for s in range(steps)]
    return trainer, state, batches


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .common import fcn_run

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="fcn", choices=("fcn", "lm"))
    ap.add_argument("--backend", default="fused", choices=("vmap", "fused"))
    ap.add_argument("--arch", default="qwen2-0.5b", help="--model lm")
    ap.add_argument("--layers", type=int, default=0,
                    help="--model lm: cut the depth to this many layers")
    ap.add_argument("--seq", type=int, default=128, help="--model lm")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    n = args.warmup + args.steps
    if args.model == "lm":
        trainer, state, batches = lm_run(args.backend, n, args.arch,
                                         args.layers, args.seq)
    else:
        trainer, state, batches = fcn_run(args.backend, "cuda", n)
    for b in batches[:args.warmup]:
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[args.warmup:]:
            state, m = trainer.train_step(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.steps
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    def kernel_ms(*parts):
        return sum(t for name, (_, t) in by_name.items()
                   if all(p in name for p in parts)) / 1e3 / args.steps

    def kernel_launches(part):
        return sum(n for name, (n, _) in by_name.items()
                   if part in name) / args.steps

    # K1 in any mode (operand or hash noise, in place or not)
    k1 = kernel_ms("analog_update", "_kernel<")
    normal = kernel_ms("hash_normal_kernel")
    drawn = kernel_ms("hash_device_kernel")
    n_drawn = kernel_launches("hash_device_kernel")
    n_normal = kernel_launches("hash_normal_kernel")
    name = torch.cuda.get_device_name(0)
    what = (f"lm {args.arch}" + (f" x{args.layers} layers" if args.layers else "")
            + f" seq {args.seq}" if args.model == "lm" else args.model)
    print(f"profile[{what}, {args.backend}] on {name}: wall {wall_ms:.2f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(kernels) / args.steps:.0f} "
          f"kernel launches/step, analog_update kernel {k1:.4f} ms/step, "
          f"hash_normal kernel {normal:.4f} ms/step ({n_normal:g} "
          f"launches/step), hash_device kernel {drawn:.4f} ms/step "
          f"({n_drawn:g} launches/step), peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    for kname, (n, t) in top:
        print(f"  {t / 1e3 / args.steps:8.4f} ms/step  {n / args.steps:6.0f}/step"
              f"  {kname[:90]}")


if __name__ == "__main__":
    main()
