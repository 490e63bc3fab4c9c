"""Where a serving step of the PyTorch port spends its time on the card.

Builds one LM at full width (``--arch``, default Qwen2-0.5B; ``--layers N``
cuts the depth as ``step_profile`` does), its weights drawn from a seed
(a step's cost does not depend on their values), and the continuous
engine's paged pools at the family's serving defaults (Qwen2: 8 lanes,
page 16, chunk 64). Every lane is prefilled with a ``--prompt``-token
prompt in chunks, as the engine's bucketed prefill runs them, then the
lanes decode together. Under ``torch.profiler`` it times ``--steps``
decode steps (``LM.serve_step_lanes`` plus the one host read of the
sampled tokens the engine makes a step) and one chunk prefill
(``LM.prefill_commit_batch`` over all lanes) and prints, for each:
  * the wall time per call (host clock around calls that end in a
    synchronize; profiler on, so a little above the untraced time),
  * device busy time per call (sum of the CUDA kernels' device time) and
    the idle share of the wall time,
  * kernel launches per call and the top kernels by device time.

Run on the card:  PYTHONPATH=src python -m repro_torch.benchmarks.serve_profile
"""
from __future__ import annotations

import argparse
import time


def _report(prof, label: str, wall_ms: float, calls: int, top: int) -> dict:
    import torch

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"serve_profile[{label}] on {torch.cuda.get_device_name(0)}: wall "
          f"{wall_ms:.3f} ms/call, device busy {busy_ms:.3f} ms/call, idle "
          f"share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels) / calls:.0f} kernel launches/call")
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / 1e3 / calls:8.4f} ms/call  {n / calls:6.0f}/call"
              f"  {kname[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                launches=len(kernels) / calls)


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import prng
    from ..configs import get_config
    from ..configs.serving import serve_defaults
    from ..models.lm import LM
    from .step_profile import cut_depth

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    cfg = get_config(args.arch)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    d = serve_defaults(cfg)
    lanes, ps, chunk = d.lanes, d.page_size, d.prefill_chunk or args.prompt
    max_len = args.prompt + args.warmup + args.steps + 1
    T = -(-max_len // ps)
    model = LM(cfg)
    with torch.no_grad():
        params = model.init(prng.PRNGKey(0), "cuda")
    paged = model.init_paged_cache(lanes, lanes * T + 1, ps, max_len,
                                   device="cuda")
    dev = torch.device("cuda")
    tables = (1 + torch.arange(lanes * T, device=dev, dtype=torch.int32)
              ).reshape(lanes, T)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, min(cfg.vocab, 8192), (lanes, args.prompt),
                            device=dev, generator=gen, dtype=torch.int32)
    ids = torch.arange(lanes, device=dev)
    ones = torch.ones(lanes, dtype=torch.bool, device=dev)

    def prefill(start: int):
        n = min(chunk, args.prompt - start)
        return model.prefill_commit_batch(
            params, prompts[:, start:start + n].contiguous(), paged, tables,
            ids, torch.full((lanes,), start, dtype=torch.int32, device=dev),
            torch.full((lanes,), n, dtype=torch.int32, device=dev),
            ones if start == 0 else ~ones)[0]

    starts = list(range(0, args.prompt, chunk))
    for s in starts[:-1]:
        prefill(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits = prefill(starts[-1])
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill": _report(prof, f"{args.arch}: {lanes} lanes x {chunk}-"
                                    f"token chunk prefill", pre_ms, 1,
                              args.top)}

    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    pos = torch.full((lanes,), args.prompt, dtype=torch.int32, device=dev)

    def step(tok, pos):
        tok, _ = model.serve_step_lanes(params, tok, paged, tables, pos, ones)
        tok.cpu()                       # the engine's one read a step
        return tok, pos + 1

    for _ in range(args.warmup):
        tok, pos = step(tok, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tok, pos = step(tok, pos)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    out["decode"] = _report(prof, f"{args.arch}: {lanes}-lane decode step",
                            dec_ms, args.steps, args.top)
    return out


if __name__ == "__main__":
    main()
