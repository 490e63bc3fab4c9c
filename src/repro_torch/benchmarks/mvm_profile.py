"""Where the analog MVM kernel (K3) spends its time on the card.

Times, at each ``--shape`` (M, K, N), in turns on the same random inputs:
the whole kernel call (``analog_mvm_cuda``: the DAC prologue and the
tensor-core product), the prologue alone, the product kernel alone with an
f32 ``w`` (three bf16 passes and the split in shared memory) and with a
bf16 ``w`` (one pass, no split), beside the plain version and cuBLAS's
product alone in f32 and in bf16. Device time per call by CUDA graph
replay, median of 15 rounds of 20 calls, each the mean over two turns (the
list, then the list reversed). Prints one line per timing, the tensor-core
rate of the product kernel, and the card's name and power limit.

Run on the card:  PYTHONPATH=src python -m repro_torch.benchmarks.mvm_profile \
                      --shape 2048 896 4864 --shape 64 784 256
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

IO = dict(inp_res=1 / 126, inp_bound=1.0, out_res=1 / 510, out_bound=12.0,
          out_noise=0.06)


def device_ms(fn, reps: int = 20, rounds: int = 15) -> float:
    """Median device ms per call of ``fn``, replayed from a CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def profile(m: int, k: int, n: int) -> None:
    import torch

    from ..kernels import ref
    from ..kernels.analog_matmul import (analog_mvm_cuda, dac_codes_cuda,
                                         mvm_codes_cuda)

    g = torch.Generator(device="cuda").manual_seed(m * 31 + n)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = 0.1 * torch.randn(k, n, device="cuda", generator=g)
    noise = torch.randn(m, n, device="cuda", generator=g)
    wb, xb = w.to(torch.bfloat16), x.to(torch.bfloat16)
    dac = dict(inp_res=IO["inp_res"], inp_bound=IO["inp_bound"])
    adc = {key: v for key, v in IO.items() if key != "inp_bound"}
    codes, s = dac_codes_cuda(x, **dac)
    fns = {
        "call": lambda: analog_mvm_cuda(x, w, noise, **IO),
        "prologue": lambda: dac_codes_cuda(x, **dac),
        "product kernel, f32 w": lambda: mvm_codes_cuda(
            codes, s, w, noise, torch.float32, **adc),
        "product kernel, bf16 w": lambda: mvm_codes_cuda(
            codes, s, wb, noise, torch.float32, **adc),
        "plain version": lambda: ref.analog_mvm_ref(x, w, noise, **IO),
        "cuBLAS f32 product": lambda: torch.matmul(x, w),
        "cuBLAS bf16 product": lambda: torch.matmul(xb, wb),
    }
    runs = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(device_ms(fns[name]))
    t = {name: sum(v) / 2 for name, v in runs.items()}
    flops = 2 * m * n * k
    for name, ms in t.items():
        passes = 3 if name in ("call", "product kernel, f32 w") else 1
        rate = (f", {passes * flops / ms / 1e9:.2f} TFLOP/s of bf16 "
                f"tensor-core work" if "kernel" in name or name == "call"
                else "")
        print(f"mvm_profile: ({m}, {k})@({k}, {n}) {name}: "
              f"{ms * 1e3:.2f} us{rate}")


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, action="append",
                    metavar=("M", "K", "N"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"mvm_profile: {card}")
    for m, k, n in args.shape or [(2048, 896, 4864), (64, 784, 256)]:
        profile(m, k, n)


if __name__ == "__main__":
    main()
