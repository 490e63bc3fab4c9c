#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    every CUDA source of the port, one nvcc each, all together
  3. kernels  each kernel's wrapper (the call the trainer makes) against
              its plain PyTorch version on the card, at the listed shapes
              and at every shape of the main path, under both RNG modes
              (analog_update: f32 bit-equal), and the kernel's time beside
              the plain version's and its memory bound
  4. quickstart  E-RIDER 32x32, 100 steps: loss and SP error fall, two
              kernel launches per step, and the card's run agrees with the
              port's CPU run (the plain path) on the same seeds
  5. fcn      the paper's FCN 784-256-128-10 at full width, batch 64,
              E-RIDER with the benchmark hyper-parameters, 30 steps under
              update_backend="vmap" and 30 under "fused": finite, falling
              loss, six kernel launches per step (the main path); the first
              3 steps agree with the port's CPU run on the same seeds
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}. It needs CUDA and imports no JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 15):
    """(device ms, call ms) per call of ``fn``, medians over ``rounds``.

    Device time: ``reps`` calls captured in one CUDA graph and replayed, so
    the card runs them back to back with no host gap; inputs stay warm in
    L2, as in the step. Call time: the same calls issued from Python, which
    includes the host's launch cost."""
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
    torch.cuda.synchronize()

    def median_of(run):
        times = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    def eager():
        for _ in range(reps):
            fn()

    graph.replay()
    return median_of(graph.replay), median_of(eager)


def update_operands(shape, dtype, seed: int, device):
    """Random w, dw, gamma, rho of the pulse update, drawn on the card."""
    import torch

    from repro_torch import prng

    ks = prng.split(prng.PRNGKey(seed), 4)
    w = prng.uniform(ks[0], shape, -0.8, 0.8, device).to(dtype)
    dw = (0.05 * prng.normal(ks[1], shape, device)).to(dtype)
    gamma = torch.exp(0.1 * prng.normal(ks[2], shape, device))
    rho = 0.3 * prng.normal(ks[3], shape, device)
    return w, dw, gamma, rho


# The listed sweep (2-D and a 3-D stack, f32 and bf16), then every shape
# the main path hands the wrapper: the quickstart's 32x32 tile, the FCN's
# three tiles one by one (update_backend="vmap") and as (1, m, n) class
# stacks (update_backend="fused").
SWEEP_SHAPES = [(8, 128), (300, 700), (512, 1024), (4, 300, 700)]
MAIN_PATH_SHAPES = [(32, 32), (784, 256), (256, 128), (128, 10),
                    (1, 784, 256), (1, 256, 128), (1, 128, 10)]


def phase_kernels(device):
    """analog_update through ``ops.analog_update``, the wrapper the trainer
    calls, against its plain version on the same operands on the card.
    Noise comes from ``ops.make_noise`` under both RNG modes, as the path
    draws it (int64 bits; the wrapper hands the kernel their int32
    pattern). float32: bit-equal; bfloat16: within one bf16 step."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.analog_update import analog_update_cuda

    kw = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1)
    cases = [(s, dt, bl, rng) for s in SWEEP_SHAPES
             for dt in (torch.float32, torch.bfloat16) for bl in (0, 10)
             for rng in ("threefry", "hash")]
    cases += [(s, torch.float32, bl, rng) for s in MAIN_PATH_SHAPES
              for bl in (0, 10) for rng in ("threefry", "hash")]
    max_err_f32 = 0.0
    for i, (shape, dtype, bl, rng) in enumerate(cases):
        w, dw, gamma, rho = update_operands(shape, dtype, 7 + i, device)
        noise = ops.make_noise(prng.PRNGKey(100 + i), shape, device, rng)
        before = ops.LAUNCHES["analog_update"]
        got = ops.analog_update(w, dw, gamma, rho, None, noise=noise, bl=bl,
                                **kw)
        check(ops.LAUNCHES["analog_update"] == before + 1,
              f"wrapper did not launch the kernel at {shape}")
        want = ref.analog_update_ref(w, dw, gamma, rho, *noise, bl=bl, **kw)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"kernel result {tuple(got.shape)} {got.dtype} at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, want)
        print(f"kernels: analog_update {shape} "
              f"{str(dtype).replace('torch.', '')} bl={bl} {rng}: "
              f"bit-equal={same} max_abs_diff={err:.3g}")
        if dtype == torch.float32:
            check(same, f"f32 kernel differs from plain at {shape} bl={bl} "
                        f"{rng}")
            max_err_f32 = max(max_err_f32, err)
        else:  # same f32 math, one round-to-nearest cast
            check(err <= 2.0 ** -7, f"bf16 kernel off by {err}")
    print(f"kernels: {len(cases)} wrapper calls checked, f32 max abs diff "
          f"{max_err_f32:.3g}")

    def timed(shape):
        """The kernel alone (its binding, int32 bits) and the plain version."""
        w, dw, gamma, rho = update_operands(shape, torch.float32, 9, device)
        ku, kz = prng.split(prng.PRNGKey(9))
        ops_ = (w, dw, gamma, rho,
                prng.bits(ku, shape, device).to(torch.int32),
                prng.normal(kz, shape, device))
        k, k_call = time_ms(lambda: analog_update_cuda(*ops_, bl=10, **kw))
        p, p_call = time_ms(lambda: ref.analog_update_ref(*ops_, bl=10, **kw))
        n = math.prod(shape)
        # 24 B read + 4 B written per element; ~30 flops per element
        bound = max(28 * n / H100_BYTES_PER_S, 30 * n / H100_F32_FLOPS) * 1e3
        print(f"kernels: analog_update {shape} f32 median device "
              f"{k * 1e3:.2f} us, per call {k_call * 1e3:.2f} us (plain: "
              f"device {p * 1e3:.2f} us, per call {p_call * 1e3:.2f} us; "
              f"memory bound {bound * 1e3:.2f} us)")
        return k, p, bound

    timed((512, 1024))
    # the main path's largest tile: the FCN's fc1, 784x256
    k, p, bound = timed((784, 256))
    return dict(max_abs_err=max_err_f32, ms=k, plain_ms=p, bound_ms=bound)


def run_quickstart(device, steps: int):
    import torch

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_quickstart as qs

    from repro_torch import prng

    trainer = qs.make_trainer(device)
    state = trainer.init(prng.PRNGKey(2),
                         {"w": torch.zeros((32, 32), device=device)})
    rows = []
    for _ in range(steps):
        state, m = trainer.train_step(state, None)
        rows.append({k: float(m[k]) for k in
                     ("true_loss", "tile/sp_err", "tile/pulses")})
    return rows


def phase_quickstart(device, steps: int = 100):
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    rows = run_quickstart(device, steps)
    launches = ops.LAUNCHES["analog_update"]
    first, last = rows[0], rows[-1]
    print(f"quickstart: {steps} steps true_loss {first['true_loss']:.4f} -> "
          f"{last['true_loss']:.4f}, sp_err {first['tile/sp_err']:.4f} -> "
          f"{last['tile/sp_err']:.4f}, kernel launches {launches}")
    check(launches == 2 * steps, f"quickstart launches {launches} != {2 * steps}")
    check(last["true_loss"] < first["true_loss"], "quickstart loss did not fall")
    check(last["tile/sp_err"] < first["tile/sp_err"], "sp_err did not fall")
    # the same seeds on the CPU take the plain path (held to the JAX package
    # by the CPU tests); the card's run must track it
    cpu = run_quickstart("cpu", steps)[-1]
    for k in ("true_loss", "tile/sp_err", "tile/pulses"):
        rel = abs(last[k] - cpu[k]) / abs(cpu[k])
        print(f"quickstart: {k} card {last[k]:.6g} vs cpu {cpu[k]:.6g} "
              f"(rel {rel:.2e})")
        check(rel < 1e-3, f"quickstart {k} off the CPU run by {rel:.2e}")


FCN_CHECK_STEPS = 3


def fcn_snapshot(state, metrics):
    """Loss, tile W per class and digital biases, on the host."""
    return dict(loss=float(metrics["loss"]),
                W={c: st["W"].detach().cpu().clone()
                   for c, st in state["tiles"].classes.items()},
                b={k: state["params"][k]["b"].detach().cpu().clone()
                   for k in ("fc1", "fc2", "out")})


def phase_fcn(device, backend: str, steps: int = 30):
    import torch

    from repro_torch.benchmarks.common import fcn_run
    from repro_torch.kernels import ops

    trainer, state, batches = fcn_run(backend, device, steps)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    losses, step_ms, card = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if len(card) < FCN_CHECK_STEPS:
            card.append(fcn_snapshot(state, m))
    launches = ops.LAUNCHES["analog_update"]
    w = state["tiles"].classes["g784x256_float32_nM"]["W"]
    check(tuple(w.shape) == (1, 1, 784, 256), f"fc1 stack shape {w.shape}")
    check(all(math.isfinite(x) for x in losses), "non-finite FCN loss")
    check(bool(torch.isfinite(w).all()), "non-finite FCN weights")
    head = statistics.mean(losses[:5])
    tail = statistics.mean(losses[-5:])
    med = statistics.median(step_ms[1:])
    print(f"fcn[{backend}]: {steps} steps loss {head:.4f} -> {tail:.4f} "
          f"(first/last 5 mean), kernel launches {launches}, "
          f"median {med:.2f} ms/step")
    check(launches == 6 * steps, f"fcn launches {launches} != {6 * steps}")
    check(tail < head, "FCN loss did not fall")
    fcn_against_cpu(backend, card, batches[:FCN_CHECK_STEPS])
    return launches, med


def fcn_against_cpu(backend: str, card, batches):
    """The card's first steps against the port's CPU run (the plain path,
    held to the JAX package by the CPU tests) from the same seeds: loss
    within rtol 1e-5; W within 1e-5 on all but at most 0.1 % of the
    elements, each of those off by at least one pulse (>= 1e-3): a
    float32 ULP apart in a gradient can flip a stochastic-rounding pulse,
    and nothing else may differ."""
    import numpy as np

    from repro_torch.benchmarks.common import fcn_run

    trainer, state, _ = fcn_run(backend, "cpu", FCN_CHECK_STEPS)
    for i, b in enumerate(batches):
        state, m = trainer.train_step(state, {k: v.cpu() for k, v in b.items()})
        cpu, got = fcn_snapshot(state, m), card[i]
        rel = abs(got["loss"] - cpu["loss"]) / abs(cpu["loss"])
        print(f"fcn[{backend}]: step {i} loss card {got['loss']:.7g} vs cpu "
              f"{cpu['loss']:.7g} (rel {rel:.2e})")
        check(rel <= 1e-5, f"fcn[{backend}] step {i} loss off the CPU run")
    for c, want in cpu["W"].items():
        diff = (got["W"][c] - want).abs().numpy()
        off = diff > 1e-5
        small = diff[off & (diff < 1e-3)]
        print(f"fcn[{backend}]: {c} W after {FCN_CHECK_STEPS} steps: "
              f"{int(off.sum())} of {diff.size} elements off the CPU run by "
              f"> 1e-5 (max {diff.max():.3g}; {small.size} of them < 1e-3)")
        check(off.mean() <= 1e-3, f"fcn[{backend}] {c} W off the CPU run")
        check(small.size == 0, f"fcn[{backend}] {c} W drifts off the CPU run")
    for k, want in cpu["b"].items():
        np.testing.assert_allclose(got["b"][k].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"fcn[{backend}] bias {k}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    card = smi_line()
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    t0 = time.time()
    cuda_build.build()
    print(f"build: {len(cuda_build.SOURCES)} source(s) in "
          f"{time.time() - t0:.1f} s")
    for name, log in cuda_build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    kern = phase_kernels(device)
    phase_quickstart(device)
    launches = 0
    for backend in ("vmap", "fused"):
        n, med = phase_fcn(device, backend)
        launches += n
        print(f"fcn[{backend}]: {med:.2f} ms/step on {card}")

    print(json.dumps({"kernels": [{
        "name": "analog_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/analog_update.cu",
        "replaces": "src/repro/kernels/analog_update.py:72",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
