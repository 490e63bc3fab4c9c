#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    every CUDA source of the port, one nvcc each, all together
  3. kernels  each kernel's wrapper (the call the trainer makes) against
              its plain PyTorch version on the card, at the listed shapes
              and at every shape of the main path, under both RNG modes
              (analog_update: f32 bit-equal), the LM path's six stacked
              bf16 tile shapes up to (24, 896, 4864) with float32 dw and
              hash noise (bit-equal), and the kernel's time beside the
              plain version's and its memory bound, at the FCN's fc1 tile
              and at (896, 4864), past the 50 MB L2
  4. mvm      the analog MVM through ``ops.analog_mvm`` at the reference
              tests' shapes (f32, bf16, ragged, rank 3), the FCN's three
              layers at batch 64 and Qwen2-0.5B's MLP up-projection on 2048
              tokens, against its plain version on the same noise: within
              one ADC step and >= 99.9 % bit-equal; one count per call (two
              CUDA launches: the DAC prologue and the tensor-core product);
              the prologue bit-equal to ``ref.dac_codes``; times of the
              call, the prologue and the product kernel beside the plain
              version's, the product alone (torch.matmul) and the bound
  5. sp_filter  the SP-tracking filter through ``ops.sp_filter`` at its
              listed shapes, the FCN's tile shapes and (896, 4864), in f32,
              bf16 and both mixed q/p pairs, at sizes around a vector and
              on views at storage offsets 1-3 (the kernel's element path):
              q_new bit-equal to the plain version, the sums within rtol
              1e-5, bit-identical from run to run and to the kernel's
              summation order replayed in torch; one CUDA launch per call;
              times at (784, 256), (896, 4864) and one element beside the
              plain version's and the memory bound
  6. quickstart  E-RIDER 32x32, 100 steps: loss and SP error fall, two
              kernel launches per step, and the card's run agrees with the
              port's CPU run (the plain path) on the same seeds
  7. fcn      the paper's FCN 784-256-128-10 at full width, batch 64,
              E-RIDER with the benchmark hyper-parameters, 30 steps under
              update_backend="vmap" and 30 under "fused": finite, falling
              loss, six kernel launches per step (the main path); the first
              3 steps agree with the port's CPU run on the same seeds
  8. ckpt     the FCN on the pcm_gst preset (update_backend="fused"), fed by
              ``Prefetcher(device="cuda")``: run A takes 10 steps with an
              asynchronous save at step 5 carrying the GDC t0 signatures;
              run B restores step 5 into ``abstract_state(device="cuda")``
              and takes steps 6-10: bit-equal to run A on every leaf, six
              kernel launches per resumed step; a CPU-template restore holds
              the saved arrays bit for bit; ``verify=True``. Then eight
              (896, 4864) E-RIDER tiles (Qwen2-0.5B's mlp/wi, about 1.1 GB
              of tile state) after one fused step: a sync save in >= 2
              chunks and a verified restore, bit-equal, with their MB/s
  9. lifetime on the FCN's effective weights restored in phase 8: age 0 is
              bit-exact, GDC against the manifest's signatures gives alpha
              == 1.0 and bit-equal weights (the same signatures checked
              on the CPU: within 1e-6 of 1); at one year every matrix has
              drifted, every alpha > 1 and GDC lowers the error to the t0
              weights; the card's aged weights agree with the port's CPU
              run within rtol 4e-6 + 1e-6 * amax|w|
 10. lm       the training CLI in process (``repro_torch.launch.train.main``):
              (a) Qwen2-0.5B at full width and depth, batch 8, seq 128,
              E-RIDER, the non-smoke tile config (bf16 state, hash noise),
              the bigram stream over 8192 token ids, 8 steps: finite loss
              and sp_err at every step, the loss falling, 2 kernel
              launches per analog path per step; prints the median step
              time, the peak allocated memory and the tile state's bytes;
              (b) the smoke config's first 3 steps on the
              card against the port's CPU run, with the smoke tile config
              (f32, threefry) and with the non-smoke one (bf16, hash); (c) a
              restart from the CLI's step-6 checkpoint, bit-equal to the
              unbroken 8-step run, its manifest carrying the GDC signatures
 11. lm_zoo   the other six archs: (a) the smoke configs of mixtral-8x7b,
              deepseek-v2-236b, minicpm3-4b, recurrentgemma-9b, mamba2-2.7b
              and seamless-m4t-large-v2 (fed frames), 3 E-RIDER steps on
              the card from a state drawn on the CPU against the same steps
              on the CPU (320 tokens: MoE's einsum dispatch): loss within
              rtol 1e-5, f32 tiles within 1e-5 but for <= 0.1 % of the
              elements, each a flipped pulse, 2 K1 launches per analog
              path per step; a CLI restart from the step-6 checkpoint
              bit-equal to the unbroken run for mixtral-8x7b (256 tokens:
              the gather dispatch), minicpm3-4b and mamba2-2.7b;
              (b) minicpm3-4b and (c) mamba2-2.7b at full
              width, depth cut to 8 layers, through the CLI's trainer
              (bf16 hash tiles, batch 8, seq 128 / 512, 6 steps): finite
              loss and sp_err, the loss falling, 2 K1 launches per analog
              path per step; prints ms/step, peak memory and tile bytes.
              Phase 3 also holds K1 bit-equal on mixtral-8x7b's 4-D expert
              stack (1, 8, 4096, 14336), bf16, and times it
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}. It needs CUDA and imports no JAX.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense


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


def update_operands(shape, dtype, seed: int, device, dw_dtype=None):
    """Random w, dw, gamma, rho of the pulse update, drawn on the card
    (``dw`` in ``dw_dtype``, default ``dtype``)."""
    import torch

    from repro_torch import prng

    ks = prng.split(prng.PRNGKey(seed), 4)
    w = prng.uniform(ks[0], shape, -0.8, 0.8, device).to(dtype)
    dw = (0.05 * prng.normal(ks[1], shape, device)).to(dw_dtype or dtype)
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
# Phase 10's path: Qwen2-0.5B at full width and depth
# (src/repro/configs/qwen2_0_5b.py: 24 layers, d_model 896, 14 heads (2 KV)
# x 64, d_ff 4864) trained by the CLI (update_backend="vmap"), which hands
# the wrapper each analog path's whole stacked leaf: bfloat16 w (the
# non-smoke tile state), float32 dw, hash noise. wq/wo, wk/wv, wi/wg,
# mlp/wo, then the 2-D stacks bq/ln1/ln2 and bk/bv.
LM_PATH_SHAPES = [(24, 896, 896), (24, 896, 128), (24, 896, 4864),
                  (24, 4864, 896), (24, 896), (24, 128)]


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
    lm_cases = len(cases)
    cases += [(s, torch.bfloat16, 0, "hash") for s in LM_PATH_SHAPES]
    max_err_f32 = 0.0
    for i, (shape, dtype, bl, rng) in enumerate(cases):
        lm = i >= lm_cases
        w, dw, gamma, rho = update_operands(
            shape, dtype, 7 + i, device, torch.float32 if lm else None)
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
              f"{str(dtype).replace('torch.', '')}"
              f"{' (dw float32)' if lm else ''} bl={bl} {rng}: "
              f"bit-equal={same} max_abs_diff={err:.3g}")
        if lm:  # the LM path's tiles: the same f32 math, the same RN cast
            check(same, f"bf16 kernel differs from plain at LM tile {shape}")
        elif dtype == torch.float32:
            check(same, f"f32 kernel differs from plain at {shape} bl={bl} "
                        f"{rng}")
            max_err_f32 = max(max_err_f32, err)
        else:  # same f32 math, one round-to-nearest cast
            check(err <= 2.0 ** -7, f"bf16 kernel off by {err}")
        del w, dw, gamma, rho, noise, got, want
    print(f"kernels: {len(cases)} wrapper calls checked, f32 max abs diff "
          f"{max_err_f32:.3g}; the LM path's {len(LM_PATH_SHAPES)} bf16 tile "
          f"shapes bit-equal")

    def timed(shape, dtype=torch.float32, reps=20, rounds=15):
        """The kernel alone (its binding, int32 bits) and the plain version,
        ``w`` in ``dtype`` and float32 ``dw``, as on the trainer's path."""
        w, dw, gamma, rho = update_operands(shape, dtype, 9, device,
                                            torch.float32)
        ku, kz = prng.split(prng.PRNGKey(9))
        ops_ = (w, dw, gamma, rho,
                prng.bits(ku, shape, device).to(torch.int32),
                prng.normal(kz, shape, device))
        k, k_call = time_ms(lambda: analog_update_cuda(*ops_, bl=10, **kw),
                            reps, rounds)
        p, p_call = time_ms(lambda: ref.analog_update_ref(*ops_, bl=10, **kw),
                            reps, rounds)
        n = math.prod(shape)
        # w read and written, dw, gamma, rho, ubits and zeta read (28 B per
        # float32 element, 24 with bf16 w); ~30 flops per element
        wb = torch.finfo(dtype).bits // 8
        bound = max((2 * wb + 20) * n / H100_BYTES_PER_S,
                    30 * n / H100_F32_FLOPS) * 1e3
        print(f"kernels: analog_update {shape} "
              f"{str(dtype).replace('torch.', '')} median device "
              f"{k * 1e3:.2f} us, per call {k_call * 1e3:.2f} us (plain: "
              f"device {p * 1e3:.2f} us, per call {p_call * 1e3:.2f} us; "
              f"memory bound {bound * 1e3:.2f} us)")
        return k, p, bound

    timed((512, 1024))
    # the main path's largest tile: the FCN's fc1, 784x256
    k, p, bound = timed((784, 256))
    # past the L2: Qwen2-0.5B's MLP tile streams 122 MB from HBM a call
    k_lm, p_lm, bound_lm = timed((896, 4864))
    # the LM path's largest launch: the stacked mlp/wi of all 24 layers
    k_st, p_st, bound_st = timed(LM_PATH_SHAPES[2], torch.bfloat16, 3, 5)
    moe = k1_moe_stack(device, kw)
    return dict(max_abs_err=max_err_f32, ms=k, plain_ms=p, bound_ms=bound,
                shape=[784, 256],
                beyond_l2=dict(ms=k_lm, plain_ms=p_lm, bound_ms=bound_lm,
                               shape=[896, 4864]),
                lm_stack=dict(ms=k_st, plain_ms=p_st, bound_ms=bound_st,
                              shape=list(LM_PATH_SHAPES[2]), dtype="bfloat16"),
                moe_stack=moe)


# Mixtral-8x7B's expert up-projection at depth 1
# (src/repro/configs/mixtral_8x7b.py: 8 experts, d_model 4096, d_ff 14336):
# the 4-D (n_periods, E, d, f) leaf full-width MoE training would hand the
# wrapper, which flattens it to a 2-D view (``ops._view2d``). 470 M elements.
MOE_STACK = (1, 8, 4096, 14336)


def k1_moe_stack(device, kw):
    """K1 through ``ops.analog_update`` on the 4-D MoE stack, bf16 w, f32
    dw, hash noise: bit-equal to its plain version; then the kernel alone
    (its binding, on the 2-D views the wrapper passes) and the plain version
    timed beside the memory bound (24 B/element). Operands come from torch's
    generator (seeded): threefry draws of 470 M elements would take tens of
    GB of int64 temporaries."""
    import gc

    import torch

    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.analog_update import analog_update_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(18)

    def draw(fn):
        return fn(MOE_STACK, generator=gen, device=device)

    w = (draw(torch.rand) * 1.6 - 0.8).to(torch.bfloat16)
    dw = 0.05 * draw(torch.randn)
    gamma = torch.exp(0.1 * draw(torch.randn))
    rho = 0.3 * draw(torch.randn)
    noise = ops.make_noise(prng.PRNGKey(18), MOE_STACK, device, "hash")
    before = ops.LAUNCHES["analog_update"]
    got = ops.analog_update(w, dw, gamma, rho, None, noise=noise, **kw)
    check(ops.LAUNCHES["analog_update"] == before + 1,
          "wrapper did not launch the kernel on the 4-D stack")
    want = ref.analog_update_ref(w, dw, gamma, rho, *noise, **kw)
    torch.cuda.synchronize()
    same = (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got, want))
    err = (got.float() - want.float()).abs().max().item()
    del got, want
    print(f"kernels: analog_update {MOE_STACK} bfloat16 (dw float32, 4-D, "
          f"through ops._view2d) hash: bit-equal={same} max_abs_diff={err:.3g}")
    check(same, f"bf16 kernel differs from plain on the 4-D stack {MOE_STACK}")
    operands = (w, dw, gamma, rho, noise[0].to(torch.int32), noise[1])
    del noise
    views = [ops._view2d(t).contiguous() for t in operands]
    k, k_call = time_ms(lambda: analog_update_cuda(*views, **kw), 3, 5)
    p, _ = time_ms(lambda: ref.analog_update_ref(*operands, **kw), 2, 3)
    n = math.prod(MOE_STACK)
    bound = max(24 * n / H100_BYTES_PER_S, 30 * n / H100_F32_FLOPS) * 1e3
    print(f"kernels: analog_update {MOE_STACK} bfloat16 median device "
          f"{k * 1e3:.2f} us, per call {k_call * 1e3:.2f} us (plain: device "
          f"{p * 1e3:.2f} us; memory bound {bound * 1e3:.2f} us, "
          f"{bound / k:.0%} of it reached)")
    del operands, views, w, dw, gamma, rho
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=k, plain_ms=p, bound_ms=bound, shape=list(MOE_STACK),
                dtype="bfloat16")


# The IO settings of the reference's tests (paper Table 7: 7-bit DAC, 9-bit
# ADC). K3's shapes, (x shape, w shape): the reference tests' products, in
# float32 and bfloat16, with the ragged and the rank-3 case of its wrapper
# tests; then, in float32, the FCN's three layers at batch 64 (the model the
# port supports) and Qwen2-0.5B's MLP up-projection (d_model 896, d_ff
# 4864, src/repro/configs/qwen2_0_5b.py) on 2048 tokens, at full width.
MVM_IO = dict(inp_res=1 / 126, inp_bound=1.0, out_res=1 / 510, out_bound=12.0,
              out_noise=0.06)
MVM_SWEEP = [((64, 128), (128, 96)), ((256, 384), (384, 512)),
             ((128, 512), (512, 256)), ((5, 33, 47), (47, 29)),
             ((2, 5, 48), (48, 32))]
MVM_MODELS = [((64, 784), (784, 256)), ((64, 256), (256, 128)),
              ((64, 128), (128, 10)), ((2048, 896), (896, 4864))]


def mvm_operands(xshape, wshape, dtype, seed: int, device):
    """Random x (normal) and w (0.1 * normal), drawn on the card."""
    from repro_torch import prng

    kx, kw = prng.split(prng.PRNGKey(seed))
    return (prng.normal(kx, xshape, device).to(dtype),
            (0.1 * prng.normal(kw, wshape, device)).to(dtype))


def mvm_bound(m: int, k: int, n: int, flops: int):
    """(ms, what bounds it): the card's least time for one f32 call, the
    longer of ``flops`` at the bf16 tensor-core peak (6MNK: the codes times
    three bf16 pieces of w) and x, w, noise, the output and the row scales
    once each at the memory rate."""
    flops_ms = flops / H100_BF16_FLOPS * 1e3
    bytes_ms = (4 * (m * k + k * n + 2 * m * n) + 4 * m) / H100_BYTES_PER_S * 1e3
    return (flops_ms, "operations") if flops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def mvm_bound_f32_simt(m: int, k: int, n: int) -> float:
    """The bound of a SIMT f32 kernel, kept beside the new one: 2MNK at the
    f32 peak outside the tensor cores, or the same bytes, whichever is
    longer (ms)."""
    bytes_ms = (4 * (m * k + k * n + 2 * m * n) + 4 * m) / H100_BYTES_PER_S * 1e3
    return max(2 * m * n * k / H100_F32_FLOPS * 1e3, bytes_ms)


def mvm_check(got, want, x2, dtype, label: str) -> float:
    """Every element within one ADC step of the plain version (out_res * s
    of its row, plus the rounding of the output to its dtype: four f32
    ULPs or one bf16 ULP of the value) and >= 99.9 % bit-equal; returns
    the largest difference."""
    import torch

    from repro_torch.kernels import ref

    got, want = got.float(), want.float()
    step = MVM_IO["out_res"] * ref.abs_max_scale(x2)
    diff = (got - want).abs()
    tol = step + want.abs() * (
        2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -21)
    equal = (got == want).float().mean().item()
    gap = (diff / step).max().item()
    print(f"mvm: {label}: bit-equal {equal * 100:.4f} %, largest gap "
          f"{gap:.4f} ADC steps, max_abs_diff {diff.max().item():.3g}")
    check(bool((diff <= tol).all()), f"mvm off by {gap} steps at {label}")
    check(equal >= 0.999, f"mvm only {equal} bit-equal at {label}")
    return diff.max().item()


# Shapes that take the kernel's middle tile size (the 14 wrapper calls take
# the large one at the LM shape and the small one elsewhere), f32 x with
# f32 and bf16 w.
MVM_TILE_CHECKS = [((1024, 256), (256, 1024))]


def phase_mvm(device):
    """The analog MVM through ``ops.analog_mvm`` against its plain version
    on the same inputs and the same noise (drawn from the call's key),
    with the gates of ``mvm_check``: the kernel's tensor-core sums and the
    plain version's cuBLAS product add in other orders, which can move y
    across an ADC rounding boundary. Then the DAC prologue alone, bit-equal
    to ``ref.dac_codes`` at every shape, and the middle tile size."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.analog_matmul import (analog_mvm_cuda,
                                                   dac_codes_cuda,
                                                   mvm_codes_cuda)

    cases = [(xs, ws, dt) for xs, ws in MVM_SWEEP
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(xs, ws, torch.float32) for xs, ws in MVM_MODELS]
    ops.reset_launch_counts()
    max_err_f32 = 0.0
    for i, (xs, ws, dtype) in enumerate(cases):
        x, w = mvm_operands(xs, ws, dtype, 30 + i, device)
        key = prng.PRNGKey(300 + i)
        got = ops.analog_mvm(x, w, key, **MVM_IO)
        m, n = math.prod(xs[:-1]), ws[1]
        x2 = x.reshape(m, -1)
        want = ref.analog_mvm_ref(x2, w, prng.normal(key, (m, n), device),
                                  **MVM_IO)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (*xs[:-1], n) and got.dtype == dtype,
              f"mvm result {tuple(got.shape)} {got.dtype} at {xs}@{ws}")
        err = mvm_check(got.reshape(m, n), want, x2, dtype,
                        f"{xs}@{ws} {str(dtype).replace('torch.', '')}")
        if dtype == torch.float32:
            max_err_f32 = max(max_err_f32, err)
    launches = dict(ops.LAUNCHES)
    print(f"mvm: {len(cases)} wrapper calls checked, launches {launches} "
          f"(two CUDA launches each: the DAC prologue and the product)")
    check(launches["analog_mvm"] == len(cases),
          f"analog_mvm launches {launches['analog_mvm']} != {len(cases)}")

    for i, (xs, ws, dtype) in enumerate(cases):
        x, _ = mvm_operands(xs, ws, dtype, 30 + i, device)
        x2 = x.reshape(-1, xs[-1])
        codes, s = dac_codes_cuda(x2, inp_res=MVM_IO["inp_res"],
                                  inp_bound=MVM_IO["inp_bound"])
        want_codes, want_s = ref.dac_codes(x2, MVM_IO["inp_res"],
                                           MVM_IO["inp_bound"])
        torch.cuda.synchronize()
        check(torch.equal(s, want_s) and torch.equal(codes.float(), want_codes),
              f"DAC prologue differs from ref.dac_codes at {xs}")
    print(f"mvm: DAC prologue codes and row scales bit-equal to "
          f"ref.dac_codes at all {len(cases)} shapes")
    for j, (xs, ws) in enumerate(MVM_TILE_CHECKS):
        for wdt in (torch.float32, torch.bfloat16):
            x, w = mvm_operands(xs, ws, torch.float32, 90 + j, device)
            w = w.to(wdt)
            noise = prng.normal(prng.PRNGKey(90 + j), (xs[0], ws[1]), device)
            got = analog_mvm_cuda(x, w, noise, **MVM_IO)
            want = ref.analog_mvm_ref(x, w, noise, **MVM_IO)
            torch.cuda.synchronize()
            mvm_check(got, want, x, torch.float32,
                      f"{xs}@{ws} f32 x, {str(wdt).replace('torch.', '')} w "
                      f"(middle tile)")

    def timed(m, k, n):
        """Device times at f32, in turns on the same inputs: the plain
        version, the product alone (torch.matmul, cuBLAS f32), the whole
        kernel call, the prologue alone and the product kernel alone; then
        the same in reverse order. Each is the mean of its two medians."""
        x, w = mvm_operands((m, k), (k, n), torch.float32, 9, device)
        noise = prng.normal(prng.PRNGKey(9), (m, n), device)
        dac = dict(inp_res=MVM_IO["inp_res"], inp_bound=MVM_IO["inp_bound"])
        adc = {key: v for key, v in MVM_IO.items() if key != "inp_bound"}
        codes, s = dac_codes_cuda(x, **dac)
        fns = dict(
            plain=lambda: ref.analog_mvm_ref(x, w, noise, **MVM_IO),
            product=lambda: torch.matmul(x, w),
            kernel=lambda: analog_mvm_cuda(x, w, noise, **MVM_IO),
            prologue=lambda: dac_codes_cuda(x, **dac),
            gemm=lambda: mvm_codes_cuda(codes, s, w, noise, torch.float32,
                                        **adc))
        runs = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                runs[name].append(time_ms(fns[name]))
        t = {name: sum(r[0] for r in rs) / 2 for name, rs in runs.items()}
        k_call = sum(r[1] for r in runs["kernel"]) / 2
        bound, by = mvm_bound(m, k, n, 6 * m * n * k)
        old = mvm_bound_f32_simt(m, k, n)
        print(f"mvm: ({m}, {k})@({k}, {n}) f32 median device "
              f"{t['kernel'] * 1e3:.2f} us (prologue {t['prologue'] * 1e3:.2f}"
              f" us, product kernel {t['gemm'] * 1e3:.2f} us), per call "
              f"{k_call * 1e3:.2f} us; plain {t['plain'] * 1e3:.2f} us; "
              f"product alone {t['product'] * 1e3:.2f} us; bound "
              f"{bound * 1e3:.2f} us by {by} (f32 SIMT bound "
              f"{old * 1e3:.2f} us); {2 * m * n * k / t['kernel'] / 1e9:.2f} "
              f"TFLOP/s f32-equivalent (2MNK), "
              f"{6 * m * n * k / t['kernel'] / 1e9:.2f} TFLOP/s tensor-core "
              f"work (6MNK)")
        return dict(ms=t["kernel"], plain_ms=t["plain"],
                    product_alone_ms=t["product"], prologue_ms=t["prologue"],
                    gemm_ms=t["gemm"], bound_ms=bound, bound_by=by,
                    bound_f32_simt_ms=old, shape=[m, k, n])

    fcn = timed(64, 784, 256)
    lm = timed(2048, 896, 4864)
    return dict(launches=launches["analog_mvm"], max_abs_err=max_err_f32,
                fcn_shape=fcn, **lm)


# K2's shapes: the reference tests' (256, 512) and (512, 1024), the ragged
# 2-D and 3-D cases of its wrapper tests, the FCN's E-RIDER tile shapes,
# and Qwen2-0.5B's MLP tile (896, 4864), past the 50 MB L2. Then the mixed
# q/p dtype pairs, sizes around one vector and one block (the tail of
# size % 4 elements), and views at storage offsets 1-3, which the kernel
# walks element by element.
SP_SHAPES = [(256, 512), (512, 1024), (33, 97), (3, 33, 97), (784, 256),
             (256, 128), (128, 10), (896, 4864)]
SP_TAUS = [(1.0, 1.0), (0.7, 1.3)]
SP_MIXED = [(33, 97), (784, 256), (896, 4864)]
SP_SMALL = [(1,), (3,), (5,), (1025,)]
SP_OFFSET = [((5,), 1), ((1025,), 2), ((33, 97), 3), ((784, 256), 1),
             ((896, 4864), 3)]


def sp_operands(shape, dtypes, seed: int, device, offset: int = 0):
    """Random q, p (in ``dtypes``), gamma, rho, drawn on the card; each a
    contiguous view at element ``offset`` of its own buffer."""
    import torch

    from repro_torch import prng

    n = math.prod(shape)
    ks = prng.split(prng.PRNGKey(seed), 4)
    full = ((0.1 * prng.normal(ks[0], (n + offset,), device)).to(dtypes[0]),
            (0.2 * prng.normal(ks[1], (n + offset,), device)).to(dtypes[1]),
            torch.exp(0.1 * prng.normal(ks[2], (n + offset,), device)),
            0.3 * prng.normal(ks[3], (n + offset,), device))
    return tuple(t[offset:].view(shape) for t in full)


def phase_sp_filter(device):
    """The SP filter through ``ops.sp_filter`` against its plain version on
    the same operands: q_new bit-equal, the sums within rtol 1e-5 (another
    summation order), bit-identical between two kernel runs and to the
    kernel's own order replayed in torch (``sums_in_launch_order``)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sp_filter as k

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(s, (f32, f32), 0) for s in SP_SHAPES]
    cases += [(s, (bf16, bf16), 0) for s in SP_SHAPES[:4]]
    cases += [(s, pair, 0) for s in SP_MIXED
              for pair in ((f32, bf16), (bf16, f32))]
    cases += [(s, pair, 0) for s in SP_SMALL for pair in ((f32, f32),
                                                         (bf16, f32))]
    cases += [(s, pair, off) for s, off in SP_OFFSET
              for pair in ((f32, f32), (bf16, bf16))]
    ops.reset_launch_counts()
    max_err, max_rel = 0.0, 0.0
    for i, (shape, dtypes, offset) in enumerate(cases):
        tau_min, tau_max = SP_TAUS[i % 2]
        kw = dict(eta=0.3, tau_min=tau_min, tau_max=tau_max)
        o = sp_operands(shape, dtypes, 50 + i, device, offset)
        q_new, gp, err = ops.sp_filter(*o, **kw)
        _, gp2, err2 = ops.sp_filter(*o, **kw)
        want = ref.sp_filter_ref(*o, **kw)
        plan = k.launch_plan(o[0].numel(), k.vector_aligned(*o))
        order = k.sums_in_launch_order(*o, plan=plan, **kw)
        torch.cuda.synchronize()
        names = "/".join(str(d).replace("torch.", "") for d in dtypes)
        label = f"{shape} {names} offset {offset}"
        check(q_new.shape == shape and q_new.dtype == dtypes[0]
              and gp.shape == () and gp.dtype == torch.float32,
              f"sp_filter result {tuple(q_new.shape)} {q_new.dtype} at "
              f"{label}")
        check(plan.vector == (offset == 0), f"sp_filter path at {label}")
        same = torch.equal(q_new, want[0])
        rel = max(abs(a.item() - b.item()) / abs(b.item())
                  for a, b in ((gp, want[1]), (err, want[2])))
        repeat = torch.equal(gp, gp2) and torch.equal(err, err2)
        in_order = torch.equal(gp, order[0]) and torch.equal(err, order[1])
        print(f"sp_filter: {label} tau=({tau_min}, {tau_max}) "
              f"{'16-byte' if plan.vector else 'element'} path, "
              f"{plan.blocks} blocks: q_new bit-equal={same}, sums "
              f"{gp.item():.7g} / {err.item():.7g} (rel diff {rel:.2e}), "
              f"repeatable={repeat}, launch order={in_order}")
        check(same, f"sp_filter q_new differs from plain at {label}")
        check(rel <= 1e-5, f"sp_filter sums off by {rel:.2e} at {label}")
        check(repeat, f"sp_filter sums changed between runs at {label}")
        check(in_order, f"sp_filter sums differ from the replayed launch "
                        f"order at {label}")
        max_err = max(max_err, (q_new.float() - want[0].float()).abs()
                      .max().item())
        max_rel = max(max_rel, rel)
    launches = dict(ops.LAUNCHES)
    print(f"sp_filter: {len(cases)} cases, launches {launches}")
    check(launches["sp_filter"] == 2 * len(cases),
          f"sp_filter launches {launches['sp_filter']} != {2 * len(cases)}")

    def timed(shape):
        o = sp_operands(shape, (f32, f32), 9, device)
        kw = dict(eta=0.3, tau_min=0.7, tau_max=1.3)
        t, t_call = time_ms(lambda: k.sp_filter_cuda(*o, **kw))
        p, p_call = time_ms(lambda: ref.sp_filter_ref(*o, **kw))
        # 16 B read + 4 B written per element; ~25 flops per element
        n = math.prod(shape)
        bound = max(20 * n / H100_BYTES_PER_S, 25 * n / H100_F32_FLOPS) * 1e3
        print(f"sp_filter: {shape} f32 median device {t * 1e3:.2f} us, per "
              f"call {t_call * 1e3:.2f} us (plain: device {p * 1e3:.2f} us, "
              f"per call {p_call * 1e3:.2f} us; memory bound "
              f"{bound * 1e3:.5f} us)")
        return dict(ms=t, plain_ms=p, bound_ms=bound, shape=list(shape))

    fcn = timed((784, 256))
    one = timed((1,))
    lm = timed((896, 4864))
    return dict(launches=launches["sp_filter"], max_abs_err=max_err,
                sums_max_rel_err=max_rel, fcn_shape=fcn, one_element=one,
                **lm)


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


CKPT_STEPS, CKPT_AT = 10, 5
LM_TILES, LM_SHAPE = 8, (896, 4864)   # Qwen2-0.5B's mlp/wi at full width
YEAR_S = 3.1536e7
LIFETIME_KEY_SEED = 0xD81F7           # the serving engine's lifetime key
AGE_RTOL, AGE_ATOL = 4e-6, 1e-6       # card vs CPU, atol in units of amax|w|
GDC_CROSS_TOL = 1e-6                  # |alpha - 1| at t0 across devices


def leaves_equal(a, b, label: str) -> int:
    """Every leaf of ``a`` bit-equal to ``b`` (same paths, dtypes; ``b`` may
    live on another device); returns the leaf count."""
    import torch

    from repro_torch.core.paths import flatten_with_path

    fa, fb = flatten_with_path(a), flatten_with_path(b)
    check([p for p, _ in fa] == [p for p, _ in fb], f"{label}: paths differ")
    for (p, x), (_, y) in zip(fa, fb):
        check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()),
              f"{label}: leaf {p} differs")
    return len(fa)


def spec_tree(params, device):
    from repro_torch.core.paths import TensorSpec, tree_map

    return tree_map(lambda t: TensorSpec(t.shape, t.dtype, device), params)


def phase_ckpt(device, root: str):
    """Train, save, restore from an abstract template, resume bit-exactly
    (the FCN); then the save and restore rates of a tile state at LM scale.
    Returns the state restored at step 5 and the manifest's signatures."""
    from repro_torch import prng
    from repro_torch.benchmarks.common import fcn_trainer
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.paths import flatten_with_path, tree_map
    from repro_torch.data import ImageDataset, Prefetcher
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import convnets

    fcn_dir = os.path.join(root, "fcn")
    data = ImageDataset(n_train=CKPT_STEPS * 64, n_test=64, seed=11)
    host_batches = list(data.epoch(0, 64))[:CKPT_STEPS]

    def producer(step):
        return host_batches[step]

    trainer = fcn_trainer("fused", preset="pcm_gst")
    params = convnets.init_convnet(prng.PRNGKey(0), convnets.ConvNetConfig(),
                                   device)
    state = trainer.init(prng.PRNGKey(1), params)
    feed = Prefetcher(producer, 0, depth=2, device=device)
    for step in range(CKPT_STEPS):
        state, m = trainer.train_step(state, next(feed))
        if step + 1 == CKPT_AT:
            extra = train.ckpt_extra(trainer, state)
            t0 = time.perf_counter()
            writer = ckpt.save(state, fcn_dir, CKPT_AT, asynchronous=True,
                               extra=extra)
            snap_s = time.perf_counter() - t0
            saved = tree_map(lambda t: t.detach().cpu().clone(), state)
    feed.close()
    writer.join(timeout=120)
    check(not writer.is_alive(), "asynchronous save did not finish")
    print(f"ckpt: fcn run A {CKPT_STEPS} steps, loss {float(m['loss']):.4f}; "
          f"async save at step {CKPT_AT} returned after {snap_s * 1e3:.1f} ms "
          f"(host snapshot), {len(extra['gdc_signatures'])} GDC signatures")

    trainer_b = fcn_trainer("fused", preset="pcm_gst")
    template = trainer_b.abstract_state(spec_tree(params, device), device)
    restored = ckpt.restore(template, fcn_dir, CKPT_AT, verify=True)
    n = leaves_equal(restored, saved, "restore of step 5")
    print(f"ckpt: restore of step {CKPT_AT} into abstract_state(device="
          f"{device!r}) with verify=True: {n} leaves bit-equal to the saved "
          f"state")
    resumed = restored
    feed = Prefetcher(producer, CKPT_AT, depth=2, device=device)
    ops.reset_launch_counts()
    for _ in range(CKPT_AT, CKPT_STEPS):
        resumed, _ = trainer_b.train_step(resumed, next(feed))
    launches = ops.LAUNCHES["analog_update"]
    feed.close()
    per_step = launches / (CKPT_STEPS - CKPT_AT)
    check(launches == 6 * (CKPT_STEPS - CKPT_AT),
          f"resumed steps launched the kernel {launches} times")
    n = leaves_equal(resumed, state, "resumed run B against run A")
    print(f"ckpt: run B (steps {CKPT_AT + 1}-{CKPT_STEPS} from the restore) "
          f"bit-equal to run A on all {n} leaves (W, P, Qd, Qt, H, device "
          f"parameters, opt, key, step); kernel launches {launches} "
          f"({per_step:g} per step)")
    on_cpu = ckpt.restore(trainer_b.abstract_state(spec_tree(params, "cpu"),
                                                   "cpu"),
                          fcn_dir, CKPT_AT, verify=True)
    check(all(v.device.type == "cpu" for _, v in flatten_with_path(on_cpu)),
          "CPU-template restore left the host")
    n = leaves_equal(on_cpu, saved, "CPU-template restore")
    print(f"ckpt: restore of step {CKPT_AT} into a CPU template: {n} leaves "
          f"bit-equal to the card's saved arrays")
    sig0 = ckpt.read_manifest(fcn_dir, CKPT_AT)["gdc_signatures"]
    check(sig0 == extra["gdc_signatures"], "manifest signatures changed")
    # phase 9 reads the restore that run B started from: the step writes
    # out of place, which this holds (ROADMAP item 17 plans in-place updates)
    leaves_equal(restored, saved, "restore of step 5 after run B")

    lm_ckpt(device, os.path.join(root, "lm"))
    return trainer_b, restored, sig0


def lm_ckpt(device, directory: str):
    """Save and restore rates of a tile state at LM scale: LM_TILES
    full-width Qwen2-0.5B mlp/wi tiles."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.device import PRESETS
    from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
    from repro_torch.core.paths import leaves
    from repro_torch.core.plan import AnalogPlan, TilePolicy
    from repro_torch.core.tile import TileConfig
    from repro_torch.core.trainer import AnalogTrainer, TrainerConfig

    dev = PRESETS["pcm_gst"]
    tile = TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                      update_backend="fused", metrics="none")
    trainer = AnalogTrainer(
        lambda p, b, r: (sum(torch.sum(w * w) for w in leaves(p)), {}),
        TrainerConfig(digital=DigitalOptConfig(kind="sgd"),
                      schedule=ScheduleConfig(kind="constant", base_lr=0.01)),
        plan=AnalogPlan.of(("**/mlp/wi", TilePolicy(tile, name="erider"))))
    ks = prng.split(prng.PRNGKey(3), LM_TILES)
    params = {"blocks": [{"mlp": {"wi": 0.02 * prng.normal(ks[i], LM_SHAPE,
                                                           device)}}
                         for i in range(LM_TILES)]}
    state = trainer.init(prng.PRNGKey(4), params)
    state, _ = trainer.train_step(state, None)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(state, directory, 1)
    save_s = time.perf_counter() - t0
    manifest = ckpt.read_manifest(directory, 1)
    nbytes = sum(math.prod(m["shape"]) * (2 if m["dtype"] == "bfloat16" else
                                          np.dtype(m["dtype"]).itemsize)
                 for m in manifest["arrays"].values())
    chunks = sorted({m["file"] for m in manifest["arrays"].values()})
    template = trainer.abstract_state(spec_tree(params, device), device)
    t0 = time.perf_counter()
    restored = ckpt.restore(template, directory, 1, verify=True)
    if device == "cuda":
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n = leaves_equal(restored, state, "LM-scale restore")
    check(len(chunks) >= 2, f"LM-scale state took {len(chunks)} chunk(s)")
    card = smi_line() if device == "cuda" else "cpu"
    print(f"ckpt: {LM_TILES} x {LM_SHAPE} E-RIDER tiles, {n} leaves, "
          f"{nbytes} bytes "
          f"in {len(chunks)} chunks: sync save {save_s:.3f} s "
          f"({nbytes / save_s / 1e6:.1f} MB/s), restore with verify=True "
          f"{restore_s:.3f} s ({nbytes / restore_s / 1e6:.1f} MB/s), "
          f"bit-equal; on {card}")


def phase_lifetime(device, trainer, restored, sig0):
    """Age and drift-compensate the effective weights restored in phase 8."""
    import torch

    from repro_torch import prng
    from repro_torch.core.paths import flatten_with_path, tree_map
    from repro_torch.core.trainer import merge_effective
    from repro_torch.lifetime import (age_params, correct_params,
                                      lifetime_cfg_map)

    eff = merge_effective(restored["params"], restored["tiles"],
                          trainer.cfg.tile)
    cfg_map = lifetime_cfg_map(eff, restored["tiles"],
                               trainer.cfg.tile.device_w)
    check(sorted(cfg_map) == sorted(sig0), "analog paths != signature paths")
    key = prng.PRNGKey(LIFETIME_KEY_SEED)
    leaves_equal(age_params(eff, cfg_map, 0.0, key), eff, "age 0")
    corr0, alpha0 = correct_params(eff, sig0)
    check(all(a == 1.0 for a in alpha0.values()),
          f"alpha at t0 is not exactly 1: {alpha0}")
    leaves_equal(corr0, eff, "GDC at t0")
    print(f"lifetime: age 0 bit-exact; GDC against the manifest's "
          f"{len(sig0)} signatures: alpha == 1.0 exactly, weights bit-equal")
    # the card's signatures checked on the CPU: another summation order
    _, alpha_cpu = correct_params(tree_map(lambda t: t.cpu(), eff), sig0)
    off = max(abs(a - 1.0) for a in alpha_cpu.values())
    check(off <= GDC_CROSS_TOL, f"CPU alpha against the card's signatures "
          f"off 1 by {off}")
    print(f"lifetime: the card's t0 signatures checked on the CPU: "
          f"max |alpha - 1| = {off:.3g} (gate {GDC_CROSS_TOL})")

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    aged = age_params(eff, cfg_map, YEAR_S, key)
    if device == "cuda":
        torch.cuda.synchronize()
    age_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    corr, alpha = correct_params(aged, sig0)
    if device == "cuda":
        torch.cuda.synchronize()
    gdc_ms = (time.perf_counter() - t0) * 1e3
    flat = dict(flatten_with_path(eff))
    aged_flat, corr_flat = dict(flatten_with_path(aged)), \
        dict(flatten_with_path(corr))
    for p in sorted(cfg_map):
        w0, wa, wc = flat[p], aged_flat[p], corr_flat[p]
        norm = torch.linalg.vector_norm(w0).item()
        raw = torch.linalg.vector_norm(wa - w0).item() / norm
        gdc = torch.linalg.vector_norm(wc - w0).item() / norm
        print(f"lifetime: {p} at one year: alpha {alpha[p]:.6f}, relative "
              f"error to t0 {raw:.4f} raw, {gdc:.4f} after GDC")
        check(not torch.equal(wa, w0), f"{p} did not drift")
        check(alpha[p] > 1.0, f"{p} alpha {alpha[p]} <= 1")
        check(gdc < raw, f"GDC did not lower the error of {p}")
    # the same inputs on the CPU
    aged_cpu = age_params(tree_map(lambda t: t.cpu(), eff), cfg_map, YEAR_S, key)
    cpu_flat = dict(flatten_with_path(aged_cpu))
    worst = 0.0
    for p, wa in flatten_with_path(aged):
        want = cpu_flat[p]
        got = wa.cpu()
        amax = flat[p].abs().max().item()
        excess = ((got - want).abs() - AGE_RTOL * want.abs()).max().item()
        worst = max(worst, excess / amax)
        check(excess <= AGE_ATOL * amax,
              f"{p}: card's aged weights off the CPU run")
    print(f"lifetime: one year, card against CPU: within rtol {AGE_RTOL} + "
          f"{AGE_ATOL} * amax|w| (largest excess over rtol {worst:.3g} amax); "
          f"age_params {age_ms:.2f} ms, correct_params {gdc_ms:.2f} ms "
          f"(host clock, synchronized)")


# Phase 10: the training CLI. (a) Qwen2-0.5B at full width and depth
# (src/repro/configs/qwen2_0_5b.py) with the CLI's defaults: batch 8, seq
# 128, E-RIDER, the non-smoke tile config (bfloat16 state, hash noise,
# device parameters redrawn from seeds), tokens from the first 8192 ids.
# (b) The smoke config on the card against the port's CPU run. (c) A
# restart from the CLI's checkpoint.
LM_STEPS = 8
LM_ARGV = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "128",
           "--algorithm", "erider", "--log-every", "1",
           # the bigram stream's table is (V, V) float64 on the host:
           # 185 GB at 151936 ids; the model keeps its full vocabulary
           "--data-vocab", "8192"]
LM_SMOKE_ARGV = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "4", "--seq",
                 "64", "--log-every", "1"]
LM_CHECK_STEPS = 3
LM_PATHS = 12                 # analog paths of the plan (ln1/ln2/b* included)


def run_cli(argv):
    """``repro_torch.launch.train.main`` in this process; returns (state,
    history, stdout). The signal handlers its PreemptionHandler installs
    are put back afterwards."""
    import contextlib
    import io
    import signal

    from repro_torch.launch import train

    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            state, hist = train.main(argv)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
        print(buf.getvalue(), end="")
    return state, hist, buf.getvalue()


def tile_state_bytes(state) -> int:
    from repro_torch.core.paths import leaves

    return sum(t.numel() * t.element_size() for t in leaves(state["tiles"]))


def phase_lm(device, card: str):
    """(a): full width, full depth, through ``train.main``."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    state, hist, _ = run_cli(LM_ARGV + ["--steps", str(LM_STEPS),
                                        "--device", device])
    launches = ops.LAUNCHES["analog_update"]
    peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()   # the final state, held
    bank = state["tiles"]
    n_paths = sum(len(ps) for _, ps in bank.index)
    shapes = sorted({tuple(st["W"].shape[2:]) for st in bank.classes.values()})
    dtypes = {str(st["W"].dtype) for st in bank.classes.values()}
    tbytes = tile_state_bytes(state)
    del state
    losses = [m["loss"] for m in hist]
    check(len(hist) == LM_STEPS, f"lm logged {len(hist)} of {LM_STEPS} steps")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["tile/sp_err"])
              for m in hist), "lm: non-finite loss or sp_err")
    check(n_paths == LM_PATHS, f"lm plan has {n_paths} analog paths")
    check(dtypes == {"torch.bfloat16"}, f"lm tile state dtypes {dtypes}")
    med = statistics.median(m["step_s"] for m in hist[1:]) * 1e3
    tail = statistics.mean(losses[-3:])
    print(f"lm: qwen2-0.5b full width, {LM_STEPS} steps, loss {losses[0]:.4f} "
          f"-> {tail:.4f} (mean of the last 3), kernel launches {launches} "
          f"({launches / LM_STEPS:g} per step, {n_paths} analog paths), tile "
          f"shapes {shapes}")
    print(f"lm: median {med:.2f} ms/step (host clock, synchronized, first "
          f"step dropped), peak allocated {peak / 2 ** 30:.3f} GiB "
          f"({before / 2 ** 30:.3f} GiB before, {resident / 2 ** 30:.3f} GiB "
          f"held by the final state), tile state {tbytes} bytes, on {card}")
    check(launches == 2 * n_paths * LM_STEPS,
          f"lm launches {launches} != {2 * n_paths * LM_STEPS}")
    check(tail < losses[0], "lm loss did not fall")
    return dict(launches=launches, step_ms=med, peak_bytes=peak,
                tile_bytes=tbytes)


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    x = torch.clamp_min(x.abs(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def lm_against_cpu(tiles: str):
    """(b): the smoke config's first steps on the card against the port's CPU
    run from the same seeds (the plain path, held to the JAX package by the
    CPU tests). Loss within rtol 1e-5 and the digital embedding within
    rtol 1e-5 (the FCN phase's float32 tolerances). Tile state (W, P, Qd,
    Qt): float32 ("smoke" tiles) within 1e-5 on all but at most 0.1 % of
    the elements (flipped stochastic-rounding pulses); bfloat16 ("full"
    tiles) bit-equal on all but at most 0.1 % of the elements, each of
    those off by at most one pulse (2 * dw_min; the response is below 2) or
    one bfloat16 ULP."""
    import numpy as np
    import torch

    argv = LM_SMOKE_ARGV + ["--steps", str(LM_CHECK_STEPS), "--tiles", tiles]
    card, card_hist, _ = run_cli(argv + ["--device", "cuda"])
    cpu, cpu_hist, _ = run_cli(argv + ["--device", "cpu"])
    for i, (g, w) in enumerate(zip(card_hist, cpu_hist)):
        rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        print(f"lm[{tiles}]: step {i} loss card {g['loss']:.7g} vs cpu "
              f"{w['loss']:.7g} (rel {rel:.2e})")
        check(rel <= 1e-5, f"lm[{tiles}] step {i} loss off the CPU run")
    dw_min = 2e-4 if tiles == "smoke" else 1e-4
    for c, want_st in cpu["tiles"].classes.items():
        counts = []
        for leaf in ("W", "P", "Qd", "Qt"):
            got = card["tiles"].classes[c][leaf].cpu()
            want = want_st[leaf]
            check(got.dtype == want.dtype, f"lm[{tiles}] {c}/{leaf} dtype")
            diff = (got.float() - want.float()).abs()
            if tiles == "smoke":
                off = diff > 1e-5
            else:
                off = diff > 0
                lim = torch.maximum(bf16_ulp(torch.maximum(got.float().abs(),
                                                           want.float().abs())),
                                    torch.full_like(diff, 2 * dw_min))
                check(bool((diff <= lim).all()),
                      f"lm[{tiles}] {c}/{leaf} off by more than a pulse")
            counts.append(f"{leaf} {int(off.sum())} (max {diff.max().item():.3g})")
            check(off.float().mean().item() <= 1e-3,
                  f"lm[{tiles}] {c}/{leaf} off the CPU run")
        print(f"lm[{tiles}]: {c} ({want_st['W'][0, 0].numel()} elements a "
              f"member) after {LM_CHECK_STEPS} steps, elements off the CPU "
              f"run: {', '.join(counts)}")
    np.testing.assert_allclose(card["params"]["embed"].float().cpu().numpy(),
                               cpu["params"]["embed"].float().numpy(),
                               rtol=1e-5, atol=1e-7, err_msg=f"lm[{tiles}] embed")


def lm_restart(root: str, smoke_argv=tuple(LM_SMOKE_ARGV)):
    """(c): run A trains 8 steps with checkpoints every 3 (async at 3 and 6,
    the last at 8); the run is then cut after its step-6 checkpoint (step 8
    removed) and run B restarts from the same directory. The cosine
    schedule spans --steps, so the unbroken run B must equal is an 8-step
    run: run A."""
    from repro_torch.checkpoint import ckpt

    argv = list(smoke_argv) + ["--ckpt-dir", root, "--device", "cuda",
                               "--steps", "8"]
    state_a, _, _ = run_cli(argv + ["--ckpt-every", "3"])
    check(ckpt.latest_step(root) == 8, "run A did not save step 8")
    sigs = ckpt.read_manifest(root, 6).get("gdc_signatures", {})
    paths = sorted(p for _, ps in state_a["tiles"].index for p in ps)
    check(sorted(sigs) == paths, "step 6 manifest lacks gdc_signatures")
    shutil.rmtree(os.path.join(root, "step_000000008"))
    state_b, hist_b, out = run_cli(argv)
    check("restored checkpoint at step 6" in out, "run B did not restore 6")
    check([m["step"] for m in hist_b] == [6, 7], "run B steps")
    n = leaves_equal(state_b, state_a, "lm restart against the unbroken run")
    print(f"lm[{argv[1]}]: restart from the step-6 checkpoint ({len(sigs)} GDC "
          f"signatures in its manifest): steps 6-7 bit-equal to the unbroken "
          f"8-step run on all {n} leaves")



# Phase 11: the rest of the LM zoo. (a) The smoke configs of the six archs
# with MoE, MLA, RG-LRU, SSD or an encoder, 3 E-RIDER steps on the card
# from a state drawn on the CPU, against the same steps on the CPU; 4 x 80
# tokens, so the MoE archs take the einsum dispatch; seamless is fed
# frames, as its LM is.
# (b) MiniCPM3-4B (src/repro/configs/minicpm3_4b.py: d_model 2560, 40
# heads, q_lora 768, kv_lora 256, qk 64+32, v 64, d_ff 6400, vocab 73448)
# and (c) Mamba2-2.7B (src/repro/configs/mamba2_2_7b.py: d_model 2560,
# d_inner 5120, 80 SSD heads of 64, d_state 128, chunk 256, vocab 50280,
# tied embeddings) at full width, each with its depth cut to 8 layers (62
# and 64 in the configs), through the CLI's trainer (``make_trainer``, bf16
# hash-noise tiles, ``update_backend="vmap"``), tokens from the first 8192
# ids, 6 steps; Mamba2 at seq 512, so SSD runs two chunks of 256. (a)
# also restarts the CLI on the card, bit-equal, for one arch of each new
# family (MoE, MLA, SSD).
LM_ZOO = ["mixtral-8x7b", "deepseek-v2-236b", "minicpm3-4b",
          "recurrentgemma-9b", "mamba2-2.7b", "seamless-m4t-large-v2"]
ZOO_BATCH, ZOO_SEQ = 4, 80
ZOO_RESTART = ["mixtral-8x7b", "minicpm3-4b", "mamba2-2.7b"]
FULL_WIDTH = [("minicpm3-4b", 128), ("mamba2-2.7b", 512)]
FULL_LAYERS, FULL_BATCH, FULL_STEPS = 8, 8, 6


def to_device(state, device):
    """A train state with every leaf on ``device`` but the host leaves
    (key, step, tile seeds)."""
    from repro_torch.core.paths import tree_map_with_path
    from repro_torch.core.trainer import HOST_LEAVES

    return tree_map_with_path(
        lambda p, t: t if p.rsplit("/", 1)[-1] in HOST_LEAVES else t.to(device),
        state)


def zoo_batches(cfg, steps: int):
    import numpy as np
    import torch

    from repro_torch.data import BigramLM

    data = BigramLM(vocab=cfg.vocab, seed=7)
    rng = np.random.default_rng(18)
    out = []
    for s in range(steps):
        b = {k: torch.from_numpy(v) for k, v in
             data.batch(s, ZOO_BATCH, ZOO_SEQ).items()}
        if cfg.frontend:
            b["frames"] = torch.from_numpy((0.1 * rng.standard_normal(
                (ZOO_BATCH, ZOO_SEQ, cfg.d_model))).astype(np.float32))
        out.append(b)
    return out


def zoo_against_cpu(arch: str) -> int:
    """(a) for one arch: the CLI's trainer with the smoke tile config (f32,
    threefry), its state drawn on the CPU and carried to the card, 3 steps
    on each. Loss within rtol 1e-5; tile state (W, P, Qd, Qt) within 1e-5
    on all but at most 0.1 % of the elements, each of those off by a
    flipped stochastic-rounding pulse: at least a tenth of dw_min and at
    most 2 * dw_min (the response is below 2); every digital leaf (the
    embedding and any other leaf outside the tile bank) within rtol 1e-5,
    as phase 10b holds the embedding; 2 K1 launches per analog path per
    step on the card. Returns the launches."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    model = LM(get_config(arch, smoke=True))
    trainer = train.make_trainer(model, "erider", True, LM_CHECK_STEPS)
    cpu = trainer.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), "cpu"))
    card = to_device(cpu, "cuda")
    batches = zoo_batches(model.cfg, LM_CHECK_STEPS)
    n_paths = sum(len(ps) for _, ps in cpu["tiles"].index)
    ops.reset_launch_counts()
    card_hist = []
    for b in batches:
        card, m = trainer.train_step(card, {k: v.cuda() for k, v in b.items()})
        card_hist.append({k: float(v) for k, v in m.items()})
    launches = ops.LAUNCHES["analog_update"]
    cpu_hist = []
    for b in batches:
        cpu, m = trainer.train_step(cpu, b)
        cpu_hist.append({k: float(v) for k, v in m.items()})
    rels = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
            for g, w in zip(card_hist, cpu_hist)]
    off_n, n_el, min_off, max_off = 0, 0, math.inf, 0.0
    pulse = 2e-4                      # dw_min of the smoke tile config
    for c, want_st in cpu["tiles"].classes.items():
        for leaf in ("W", "P", "Qd", "Qt"):
            got = card["tiles"].classes[c][leaf].cpu()
            want = want_st[leaf]
            check(got.dtype == want.dtype == torch.float32,
                  f"zoo[{arch}] {c}/{leaf} dtype")
            diff = (got - want).abs()
            off = diff > 1e-5
            check(off.float().mean().item() <= 1e-3,
                  f"zoo[{arch}] {c}/{leaf} off the CPU run")
            if bool(off.any()):
                min_off = min(min_off, diff[off].min().item())
                max_off = max(max_off, diff[off].max().item())
            off_n += int(off.sum())
            n_el += off.numel()
    digital = flatten_with_path(cpu["params"])
    got_digital = dict(flatten_with_path(card["params"]))
    check(sorted(got_digital) == sorted(p for p, _ in digital),
          f"zoo[{arch}] digital leaves differ")
    worst = 0.0
    for p, want in digital:
        got = got_digital[p].float().cpu().numpy()
        want = want.float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=f"zoo[{arch}] {p}")
        worst = max(worst, float(np.max(np.abs(got - want)
                                        / (1e-7 + 1e-5 * np.abs(want)))))
    print(f"zoo[{arch}]: {n_paths} analog paths, {launches} K1 launches in "
          f"{LM_CHECK_STEPS} steps; loss card vs cpu rel "
          f"{', '.join(f'{r:.2e}' for r in rels)} (step 0 {card_hist[0]['loss']:.6g}); "
          f"tile elements off by > 1e-5: {off_n} of {n_el}"
          + (f" (smallest {min_off:.3g}, largest {max_off:.3g})" if off_n
             else "")
          + f"; {len(digital)} digital leaves, the largest diff "
          f"{worst:.3f} x its tolerance (rtol 1e-5, atol 1e-7)")
    check(all(math.isfinite(h["loss"]) for h in card_hist),
          f"zoo[{arch}] non-finite loss")
    check(max(rels) <= 1e-5, f"zoo[{arch}] loss off the CPU run")
    check(min_off >= 0.1 * pulse, f"zoo[{arch}] an element off by less than "
                                   f"a tenth of a pulse ({min_off})")
    check(max_off <= 2 * pulse, f"zoo[{arch}] an element off by more than "
                                f"a pulse ({max_off})")
    check(launches == 2 * n_paths * LM_CHECK_STEPS,
          f"zoo[{arch}] launches {launches} != {2 * n_paths * LM_CHECK_STEPS}")
    return launches


def lm_full_width(arch: str, seq: int, card: str):
    """(b), (c): one arch at full width, depth cut to FULL_LAYERS, through
    the CLI's ``make_trainer`` and ``trainer.jit_step()``: finite loss and
    sp_err at every step, the loss falling (mean of the last 3 below the
    first), 2 K1 launches per analog path per step. Records ms/step
    (median over steps 2-6, host clock, synchronized), the peak allocated
    memory, the tile state's bytes and the launches."""
    import gc

    import torch

    from repro_torch import prng
    from repro_torch.benchmarks.step_profile import cut_depth
    from repro_torch.configs import get_config
    from repro_torch.data import BigramLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    cfg = cut_depth(get_config(arch), FULL_LAYERS)
    model = LM(cfg)
    trainer = train.make_trainer(model, "erider", False, FULL_STEPS)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state = trainer.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), "cuda"))
    data = BigramLM(vocab=8192, seed=7)
    step_fn = trainer.jit_step()
    bank = state["tiles"]
    n_paths = sum(len(ps) for _, ps in bank.index)
    n_analog = sum(st["W"].numel() for st in bank.classes.values())
    largest = max(st["W"][0, 0].numel() for st in bank.classes.values())
    tbytes = tile_state_bytes(state)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    hist = []
    for s in range(FULL_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(s, FULL_BATCH, seq).items()}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hist.append(dict(loss=float(m["loss"]), sp_err=float(m["tile/sp_err"]),
                         step_s=dt))
    launches = ops.LAUNCHES["analog_update"]
    peak = torch.cuda.max_memory_allocated()
    dtypes = {str(st["W"].dtype) for st in bank.classes.values()}
    del state, bank, m
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    med = statistics.median(h["step_s"] for h in hist[1:]) * 1e3
    tail = statistics.mean(losses[-3:])
    print(f"lm[{arch}]: full width, {FULL_LAYERS} of {get_config(arch).n_layers}"
          f" layers, batch {FULL_BATCH} x seq {seq}, {FULL_STEPS} steps, loss "
          f"{losses[0]:.4f} -> {tail:.4f} (mean of the last 3), sp_err "
          f"{hist[0]['sp_err']:.4g} -> {hist[-1]['sp_err']:.4g}; {n_paths} "
          f"analog paths, {n_analog} analog elements (largest leaf "
          f"{largest}), tile dtypes {sorted(dtypes)}; K1 launches {launches} "
          f"({launches / FULL_STEPS:g} per step)")
    print(f"lm[{arch}]: median {med:.2f} ms/step (host clock, synchronized, "
          f"first step dropped), peak allocated {peak / 2 ** 30:.3f} GiB "
          f"({before / 2 ** 30:.3f} GiB before), tile state {tbytes} bytes, "
          f"on {card}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["sp_err"])
              for h in hist), f"lm[{arch}]: non-finite loss or sp_err")
    check(dtypes == {"torch.bfloat16"}, f"lm[{arch}] tile dtypes {dtypes}")
    check(tail < losses[0], f"lm[{arch}] loss did not fall")
    check(launches == 2 * n_paths * FULL_STEPS,
          f"lm[{arch}] launches {launches} != {2 * n_paths * FULL_STEPS}")
    return dict(launches=launches, step_ms=med, peak_bytes=peak,
                tile_bytes=tbytes, analog_elements=n_analog, layers=FULL_LAYERS,
                seq=seq)


def phase_lm_zoo(card: str):
    import torch

    t0 = time.time()
    zoo = sum(zoo_against_cpu(arch) for arch in LM_ZOO)
    # (a) also: a CLI restart on the card, bit-equal to the unbroken run,
    # for one arch of each new family; mixtral at 256 tokens a step takes
    # MoE's gather path, which (a)'s 320 tokens do not
    root = os.path.join(ROOT, "build", "lm_zoo_smoke")
    for arch in ZOO_RESTART:
        shutil.rmtree(root, ignore_errors=True)
        try:
            lm_restart(root, ["--arch", arch, "--smoke", "--batch", "4",
                              "--seq", "64", "--log-every", "1"])
        finally:
            shutil.rmtree(root, ignore_errors=True)
    full = {arch: lm_full_width(arch, seq, card) for arch, seq in FULL_WIDTH}
    torch.cuda.synchronize()
    print(f"lm_zoo: phase 11 took {time.time() - t0:.1f} s")
    return zoo, full


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
    mvm = phase_mvm(device)
    spf = phase_sp_filter(device)
    phase_quickstart(device)
    launches = 0
    for backend in ("vmap", "fused"):
        n, med = phase_fcn(device, backend)
        launches += n
        print(f"fcn[{backend}]: {med:.2f} ms/step on {card}")
    root = os.path.join(ROOT, "build", "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        trainer, restored, sig0 = phase_ckpt(device, root)
        phase_lifetime(device, trainer, restored, sig0)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    lm = phase_lm(device, card)
    for tiles in ("smoke", "full"):
        lm_against_cpu(tiles)
    lm_root = os.path.join(ROOT, "build", "lm_smoke")
    shutil.rmtree(lm_root, ignore_errors=True)
    try:
        lm_restart(lm_root)
    finally:
        shutil.rmtree(lm_root, ignore_errors=True)
    print(f"lm: {lm['step_ms']:.2f} ms/step on {card}")

    zoo, full = phase_lm_zoo(card)
    for arch, r in full.items():
        print(f"lm[{arch}]: {r['step_ms']:.2f} ms/step, peak "
              f"{r['peak_bytes'] / 2 ** 30:.3f} GiB on {card}")

    kern["launches"] = (launches + lm["launches"] + zoo
                        + sum(r["launches"] for r in full.values()))
    kern["lm_launches"] = lm["launches"]
    kern["zoo_launches"] = zoo
    kern["full_width"] = full
    print(json.dumps({"kernels": [
        dict(name="analog_update", route="cuda",
             source="src/repro_torch/kernels/csrc/analog_update.cu",
             replaces="src/repro/kernels/analog_update.py:72",
             bound_by="bytes", library_ms=None, **kern),
        dict(name="analog_mvm", route="cuda",
             source="src/repro_torch/kernels/csrc/analog_mvm.cu",
             replaces="src/repro/kernels/analog_matmul.py:59",
             library_ms=None, **mvm),
        dict(name="sp_filter", route="cuda",
             source="src/repro_torch/kernels/csrc/sp_filter.cu",
             replaces="src/repro/kernels/sp_filter.py:56",
             bound_by="bytes", library_ms=None, **spf)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
