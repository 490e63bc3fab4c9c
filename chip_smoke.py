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
              the plain version's and its memory bound, at the FCN's fc1
              tile and at (896, 4864), past the 50 MB L2
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
    # past the L2: Qwen2-0.5B's MLP tile streams 122 MB from HBM a call
    k_lm, p_lm, bound_lm = timed((896, 4864))
    return dict(max_abs_err=max_err_f32, ms=k, plain_ms=p, bound_ms=bound,
                shape=[784, 256],
                beyond_l2=dict(ms=k_lm, plain_ms=p_lm, bound_ms=bound_lm,
                               shape=[896, 4864]))


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

    kern["launches"] = launches
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
