"""Where one training step of the PyTorch port spends its time on the card.

Runs the paper's FCN step (``repro_torch.benchmarks.common``) for a few warm-up
steps, then ``--steps`` steps under ``torch.profiler``, and prints:
  * the wall time per step (host clock around steps that end in a
    synchronize; profiler on, so a little above the untraced time),
  * device busy time per step (sum of the CUDA kernels' device time) and
    the idle share of the wall time,
  * kernel launches per step, the pulse-update kernel's share, and the top
    kernels by device time.

Run on the card:  PYTHONPATH=src python -m repro_torch.benchmarks.step_profile \
                      --backend fused --steps 10
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .common import fcn_run

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="fused", choices=("vmap", "fused"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    trainer, state, batches = fcn_run(args.backend, "cuda",
                                      args.warmup + args.steps)
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
    k1 = sum(t for name, (_, t) in by_name.items()
             if "analog_update_kernel" in name) / 1e3 / args.steps
    name = torch.cuda.get_device_name(0)
    print(f"profile[{args.backend}] on {name}: wall {wall_ms:.2f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(kernels) / args.steps:.0f} "
          f"kernel launches/step, analog_update kernel {k1:.4f} ms/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    for kname, (n, t) in top:
        print(f"  {t / 1e3 / args.steps:8.4f} ms/step  {n / args.steps:6.0f}/step"
              f"  {kname[:90]}")


if __name__ == "__main__":
    main()
