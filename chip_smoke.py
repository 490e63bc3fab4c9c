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
              and at (896, 4864), past the 50 MB L2; K1's in-place mode
              (``repro_torch::analog_update_``, the donated step's) through
              the wrapper bit-equal to the out-of-place kernel and timed
              beside its plain version at (784, 256), (896, 4864), the LM
              stack (24, 896, 4864) and the 4-D MoE stack; then the
              Hopper form of ``kernels/fastrng.py`` (``phase_kernels_hash``):
              K1's hash-noise mode (``repro_torch::analog_update_hash``,
              in place ``::analog_update_hash_``), which draws its noise
              in the kernel, both instantiations bit-equal to the operand
              mode fed the eager hash draws at the sweep, main-path and LM
              shapes (a seed a member of a stack; on the LM stacks also
              one seed a tile, as the CLI draws) and on the MoE stack (a
              seed an expert), ``repro_torch::hash_normal``
              (``csrc/fastrng.cu``) bit-equal to the eager chain for
              salts 2, 11, 13 and 17 on the (24, 896, 4864) stack, and
              ``repro_torch::hash_device`` (the device draw of
              ``core/device.py``, ``csrc/fastrng.cu``) bit-equal to its
              eager chain for the CLI's W and P devices and one without
              sigma_d2d, at (896, 4864) with one seed and (24, 896, 4864)
              with 24 and with one; each timed against its bound beside
              the plain version; the exhaustive checks of those kernels'
              exact rewrites on check kernels only this script launches
              (every divisor K1 takes from the repo's configs and 24 drawn
              at random, each over all 2^32 float32 x, the normal's
              division over all 2^23 mantissas, every whole |n_q| through
              the square-root table: 0 mismatches each), and each
              kernel's SASS instructions an
              element (``benchmarks/sass_count.py`` on this run's build),
              whose issue bound is printed beside each time
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
              E-RIDER with the benchmark hyper-parameters, 30 donated steps
              (``trainer.jit_step()``) under update_backend="vmap" and 30
              under "fused": finite, falling loss, six kernel launches per
              step, all in place, every leaf on its own storage (the main
              path); bit-equal on every leaf and loss to 30 out-of-place
              steps from a copy of the same state; the first 3 steps agree
              with the port's CPU run on the same seeds; every "fused" K1
              launch in K1's hash-noise mode, none under "vmap" (threefry)
  8. ckpt     the FCN on the pcm_gst preset (update_backend="fused"), fed by
              ``Prefetcher(device="cuda")``: run A takes 10 donated steps
              with an asynchronous save at step 5 carrying the GDC t0
              signatures; run B restores step 5 into
              ``abstract_state(device="cuda")``, keeps a copy of it, and
              takes donated steps 6-10: bit-equal to run A on every leaf,
              six in-place kernel launches per resumed step; a CPU-template restore holds
              the saved arrays bit for bit; ``verify=True``. Then eight
              (896, 4864) E-RIDER tiles (Qwen2-0.5B's mlp/wi, about 1.1 GB
              of tile state) after one fused step: a sync save in >= 2
              chunks and a verified restore, bit-equal, with their MB/s
  9. lifetime on the FCN's effective weights restored in phase 8 (the
              copy of the restore): age 0 is
              bit-exact, GDC against the manifest's signatures gives alpha
              == 1.0 and bit-equal weights (the same signatures checked
              on the CPU: within 1e-6 of 1); at one year every matrix has
              drifted, every alpha > 1 and GDC lowers the error to the t0
              weights; the card's aged weights agree with the port's CPU
              run within rtol 4e-6 + 1e-6 * amax|w|
 10. lm       the training CLI in process (``repro_torch.launch.train.main``):
              (a) Qwen2-0.5B at full width and depth, batch 8, seq 128,
              E-RIDER, the non-smoke tile config (bf16 state, hash noise),
              the bigram stream over 8192 token ids, 8 steps of the CLI's
              donated step: finite loss and sp_err at every step, the loss
              falling, 2 kernel launches per analog path per step, all in
              place and in K1's hash-noise mode, with one
              ``hash_device`` launch a K1 launch (the device drawn once
              an array an update) and no ``hash_normal`` launch; prints
              the median step time, those launches a step, the peak
              allocated memory and the tile state's bytes;
              (b) the smoke config's first 3 steps on the
              card against the port's CPU run, with the smoke tile config
              (f32, threefry: no hash kernel launched) and with the
              non-smoke one (bf16, hash: the hash kernels only); (c) a
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
              (bf16 hash tiles, batch 8, seq 128 / 512, 4 steps): finite
              loss and sp_err, the loss falling, 2 K1 launches per analog
              path per step, in K1's hash-noise mode, one
              ``hash_device`` launch a K1 launch and no ``hash_normal``
              launch; prints ms/step, those launches a step, peak memory
              and tile bytes.
              Phase 3 also holds K1 bit-equal on mixtral-8x7b's 4-D expert
              stack (1, 8, 4096, 14336), bf16, and times it
 12. serve    serving (``repro_torch.serving``, ``launch/serve.py``):
              (a) the smoke configs of qwen2-0.5b, qwen3-14b, gemma3-4b
              (also with a prompt past its 16-token window), qwen2-vl-2b and
              mixtral-8x7b on the reference tests' workload (5 requests,
              prompt 10, gen 4+-2, 2 lanes, page 4, a shared 8-token
              prefix, chunk 8): the continuous engine's tokens equal the
              fixed driver's on the card, and both equal the CPU run's on
              the same parameters; serving launches no K1/K2/K3;
              (b) Qwen2-0.5B at full width and depth trained 2 steps by the
              CLI (48 K1 launches, 48 ``hash_device``), checkpointed,
              then served by the serve
              CLI aged one year with GDC (16 requests, prompt 128, gen 32,
              8 lanes, page 16, chunk 64) and by the fixed driver: the
              manifest validates with t0 signatures from the checkpoint,
              32 tokens a request, each stream equal to the fixed driver's
              up to a first difference at a near-tie (top two logits
              within 2 bf16 ULPs), no K1/K2/K3 or ``hash_device``
              launch (the aged loads' drift normals through
              ``hash_normal``); prints tokens/s,
              TTFT/TPOT p50/p99, the decode step, peak memory,
              save/restore seconds
 13. serve_zoo  serving the other families: (a) the smoke configs of
              minicpm3-4b, deepseek-v2-236b (MLA latent rows),
              recurrentgemma-9b (RG-LRU state) and mamba2-2.7b (SSD state)
              on phase 12a's workload: continuous == fixed on the card ==
              the CPU run; seamless-m4t-large-v2 through the fixed driver
              with frames, the card == the CPU; no K1/K2/K3 launch;
              (b) MiniCPM3-4B at full width and depth (62 layers, bf16,
              weights from ``LM.init`` on the card) through the serve CLI
              (16 requests, prompt 128, gen 32, 8 lanes, page 16, chunk 64)
              and the fixed driver (batch 8); (c) Mamba2-2.7B at full width
              and depth (64 layers; 32 requests, prompt 512, gen 32, 16
              lanes, page 32, chunk 256: the SSD state carried across a
              chunk) and the fixed driver (batch 16). For (b) and (c): each
              stream equal to the fixed driver's up to a first difference
              at a near-tie (the count printed), no K1/K2/K3 launch; prints
              tokens/s, TTFT/TPOT p50/p99, the decode step, kernel launches
              and device time per decode step (``torch.profiler``) and peak
              memory
 14. paper    the paper's own workloads through the port's benchmark
              harness (``repro_torch.benchmarks.common``): (a) LeNet-5 at
              full width, E-RIDER, under update_backend "vmap" and "fused":
              the first 3 steps on the card against the port's CPU run
              from one state drawn on the CPU (phase 11a's standard: loss
              within rtol 1e-5, every float tile leaf within 1e-5 but for
              <= 0.1 % of its elements, each where a stochastic-rounding
              pulse of P flipped), 2 K1 launches per tile per step, and a
              second card run bit-equal to the first (deterministic
              cuDNN); the cost of the harness's per-step host reads;
              (b) TT-v2, AGAD and E-RIDER on the FCN and on LeNet-5 at
              examples/analog_mnist.py's setting (~4-state devices, SP
              reference N(0.4, 0.4^2), 2 epochs of 4096 images, seed 1):
              test_acc, sp_err, pulses, wall seconds each; E-RIDER's
              test_acc above TT-v2's on each model; (c)
              tests/test_system.py's FCN run
              (dw_min 0.02, SP reference N(0.3, 0.2^2), 1 epoch, seed 0):
              the loss falls, test_acc > 0.3, sp_err < 0.3^2 + 0.2^2.
              Phase 3 also holds K1 bit-equal at LeNet-5's tile shapes
 15. dist     distribution (``distributed/``, ``launch/mesh.py``): ranks as
              spawned processes sharing the card over gloo, collectives
              staged through host memory: (a) the int8 compressed
              all-reduce of a (2, 2^24) float32 gradient, card == CPU bit
              for bit, within the reference's bounds; (b) Qwen2-0.5B's
              full-width tile bank (the CLI's plan, at (c)'s step 2)
              through one begin_step and update on two data ranks,
              gathered, bit-equal to one process, K1 launches, rows and
              device time per rank; (c) the
              CLI of phase 10a with --data-parallel 2, 4 steps with a
              restart on the mesh at step 2 (run A's 2-step schedule
              gives step 0 the learning rate of phase 10a's): loss finite
              and falling on average (a trend only), steps 0 and 1 each
              within 1e-3 (relative) of phase 10a's, ms/step, peak memory,
              tile bytes and gradient all-reduce ms per rank; the step-2
              checkpoint restored by rank 0 in a trainer with no mesh,
              every leaf equal (``torch.equal``) to the ranks' gathered
              state, and one more step; (d) the reference's 2x2
              sharded bank on four ranks: its specs, tile bytes per rank
              <= total / 2 + 1024, two steps bit-equal to one process
 16. tp       compute over the model axis (``--model-parallel``,
              ``distributed.sharding.tp_layout``), ranks as in phase 15:
              (a) phase 10a's CLI run with --model-parallel 2, 3 steps:
              steps 0-1 within 1e-3 (relative) of phase 10a's, no
              model-group all-gather of a weight in the forward,
              model-group all-reduces a step and K1 launches a rank as
              ``tp_layout`` and the bank predict; ms/step, the
              all-reduces' ms and bytes, peak memory and tile bytes a
              rank, and the model's forward and backward profiled a rank
              against one process's; (b) the smoke LM on a (2, 2) mesh of
              four ranks, card == CPU (loss rtol 1e-5, leaves within 1e-5
              but for <= 0.1 %)
 17. tp_mixers  the model axis for MLA, RG-LRU, SSD, cross-attention and
              the encoder-decoder, ranks as in phase 16: (a) MiniCPM3-4B
              (MLA) and (b) Mamba2-2.7B (SSD, B/C read whole at one group)
              at full width, 4 layers, through the CLI's trainer with
              --model-parallel 2, 2 steps, against one rank of the same
              depth: steps 0-1 within 1e-3 (relative), model-group
              all-reduces a step as ``tp_layout`` predicts, no split
              weight gathered in the forward, K1 launches a rank as the
              bank predicts; ms/step, the all-reduces' ms, peak memory and
              tile bytes a rank, the model's forward and backward profiled
              a rank against one rank's; (c) the smoke RecurrentGemma-9B,
              SeamlessM4T (fed frames) and DeepSeek-V2 on (1, 2), card ==
              CPU (loss rtol 1e-5, leaves within 1e-5 but for <= 0.1 %)
 18. analysis  the op-trace layer (``repro_torch.analysis``,
              ``roofline``, ``launch/dryrun.py``): (a) K2 on two streams at
              once (20 calls each at (896, 4864), different data), every
              call's sums bit-equal to ``sums_in_launch_order``; the seven
              graph contracts on CUDA tensors, traced, every rule but the
              CPU memory ceiling, the serve entrypoints and begin_step under
              ``torch.cuda.set_sync_debug_mode("error")``: ops, uploads,
              host reads, K1 records and bytes each, the train contracts
              with their state kept in place (donation) and every K1 launch
              in place; the restack, no_donate, host_transfer and f64
              mutants caught on one entrypoint each;
              (b) ``dryrun.account_step`` of phase 10a's donated step on
              ``meta`` (and of the out-of-place one, printed) against the
              donated step on the card: predicted peak within 10 % of
              ``max_memory_allocated``, tile bytes exact; two donated LM
              steps bit-equal to two out-of-place steps from the same init
              on every leaf and loss; (c)
              qwen2-0.5b ``train_4k`` and gemma3-4b ``long_500k`` on
              pod16x16 and mamba2-2.7b ``decode_32k`` on pod2x16x16 on the
              host, after the card's phases: per-rank peak, bottleneck,
              roofline fraction. Before (c), a CUDA graph
              capture of serve_step_lanes (whether it captures, whether a
              replay equals the eager step: a measurement, not a gate);
              (d) Qwen2-0.5B at full width and depth through the fixed
              ``prefill`` + ``serve_step`` (batch 8, prompt 128, 16 greedy
              tokens) on two model ranks of a (1, 2) mesh sharing the card
              (``launch.serve.fixed_generate``; the cache split on
              head_dim): tokens identical to one process's, model-group
              calls and bytes a decode step; (e) ``dryrun.account_serve``
              of that model's ``serve_step`` on ``meta``, one process, at
              (d)'s batch and cache length: the step's bytes within 10 %
              of the bytes the step requested of the allocator (the rise
              of ``max_memory_allocated`` printed beside);
              (f) gemma3-4b at full width cut to 16 layers (two periods
              of five local layers and a global one, the four-layer local
              tail), batch 1, on the two data ranks of a (2, 1) mesh
              sharing the card, every rank computing the row: the body
              caches split their period axis (broadcast from the rank
              that holds the period, ``cache/reshard``), the tail's
              1024-slot rings their sequence (each rank's partial softmax
              merged by log-sum-exp, ``attn/seq_merge``): (i)
              ``fixed_generate`` with a 4096-token prompt and 8 greedy
              tokens, identical to one process's; (ii) one step at
              position 524287 of a 524288-slot cache filled from seeds:
              the token equal to one process's or a near tie, the logits
              and the slots the step wrote within ``LONG_ULPS`` bf16 ULPs
              of their amax, every other slot its seeded value; (iii)
              ``dryrun.account_serve`` of the one process's step on
              ``meta`` within 10 % of the rise of ``max_memory_allocated``
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}. It needs CUDA and imports no JAX.
"""
from __future__ import annotations

import gc
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
# Phase 14's LeNet-5 tiles: the HWIO conv kernels, which the wrapper views
# as (25, 16) and (400, 32), and fc1/fc2, one by one ("vmap") and as
# (1, ...) class stacks ("fused")
LENET_SHAPES = [(5, 5, 1, 16), (5, 5, 16, 32), (1568, 512), (512, 128)]
MAIN_PATH_SHAPES += LENET_SHAPES + [(1,) + s for s in LENET_SHAPES]
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
        ``w`` in ``dtype`` and float32 ``dw``, as on the trainer's path;
        then the in-place mode (``repro_torch::analog_update_``, which the
        donated step launches): through the wrapper bit-equal to the
        out-of-place kernel on the same operands, and timed beside its
        plain version (the plain update written into ``w``)."""
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
        # float32 element, 24 with bf16 w); ~30 flops per element. The
        # in-place mode moves the same bytes.
        wb = torch.finfo(dtype).bits // 8
        bound = max((2 * wb + 20) * n / H100_BYTES_PER_S,
                    30 * n / H100_F32_FLOPS) * 1e3
        issue = issue_ms(k1_label(dtype, torch.float32, False), n)
        print(f"kernels: analog_update {shape} "
              f"{str(dtype).replace('torch.', '')} median device "
              f"{k * 1e3:.2f} us, per call {k_call * 1e3:.2f} us (plain: "
              f"device {p * 1e3:.2f} us, per call {p_call * 1e3:.2f} us; "
              f"memory bound {bound * 1e3:.2f} us, issue bound "
              f"{issue * 1e3:.2f} us)")
        want = analog_update_cuda(*ops_, bl=10, **kw)
        w2 = w.clone()
        before = ops.LAUNCHES["analog_update_"]
        got = ops.analog_update(w2, *ops_[1:4], None, noise=ops_[4:], bl=10,
                                out=w2, **kw)
        torch.cuda.synchronize()
        check(got is w2 and ops.LAUNCHES["analog_update_"] == before + 1,
              f"the wrapper did not launch K1's in-place mode at {shape}")
        same = torch.equal(w2, want)
        err = (w2.float() - want.float()).abs().max().item()
        check(same, f"K1 in place differs from out of place at {shape}: "
                    f"{err}")
        ip_ops = (w2,) + ops_[1:]
        ki, ki_call = time_ms(
            lambda: analog_update_cuda(*ip_ops, bl=10, out=w2, **kw),
            reps, rounds)
        pi, _ = time_ms(lambda: w2.copy_(ref.analog_update_ref(
            *ip_ops, bl=10, **kw)), reps, rounds)
        print(f"kernels: analog_update_ (in place) {shape} "
              f"{str(dtype).replace('torch.', '')}: bit-equal to the "
              f"out-of-place kernel={same}; median device {ki * 1e3:.2f} us, "
              f"per call {ki_call * 1e3:.2f} us (plain, written back: device "
              f"{pi * 1e3:.2f} us; memory bound {bound * 1e3:.2f} us)")
        del want, w2, got
        return k, p, bound, dict(ms=ki, plain_ms=pi, bound_ms=bound,
                                 issue_ms=issue, max_abs_err=err,
                                 shape=list(shape),
                                 dtype=str(dtype).replace("torch.", ""))

    timed((512, 1024))
    # the main path's largest tile: the FCN's fc1, 784x256
    k, p, bound, ip = timed((784, 256))
    # past the L2: Qwen2-0.5B's MLP tile streams 122 MB from HBM a call
    k_lm, p_lm, bound_lm, ip_lm = timed((896, 4864))
    # the LM path's largest launch: the stacked mlp/wi of all 24 layers
    k_st, p_st, bound_st, ip_st = timed(LM_PATH_SHAPES[2], torch.bfloat16,
                                        3, 5)
    moe, ip_moe = k1_moe_stack(device, kw)
    inplace = dict(ip, beyond_l2=ip_lm, lm_stack=ip_st, moe_stack=ip_moe)
    inplace["max_abs_err"] = max(
        d["max_abs_err"] for d in (ip, ip_lm, ip_st, ip_moe))
    return dict(max_abs_err=max_err_f32, ms=k, plain_ms=p, bound_ms=bound,
                shape=[784, 256],
                beyond_l2=dict(ms=k_lm, plain_ms=p_lm, bound_ms=bound_lm,
                               shape=[896, 4864]),
                lm_stack=dict(ms=k_st, plain_ms=p_st, bound_ms=bound_st,
                              issue_ms=ip_st["issue_ms"],
                              shape=list(LM_PATH_SHAPES[2]), dtype="bfloat16"),
                moe_stack=moe), inplace


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
    # the in-place mode on the same stack: through the wrapper, bit-equal to
    # the out-of-place kernel, then timed on the wrapper's views
    want = analog_update_cuda(*views, **kw).reshape(MOE_STACK)
    before = ops.LAUNCHES["analog_update_"]
    ops.analog_update(w, dw, gamma, rho, None, noise=operands[4:], out=w,
                      **kw)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["analog_update_"] == before + 1,
          "the wrapper did not launch K1's in-place mode on the 4-D stack")
    same = torch.equal(w, want)
    err = (w.float() - want.float()).abs().max().item()
    del want
    check(same, f"K1 in place differs from out of place on {MOE_STACK}")
    ki, ki_call = time_ms(
        lambda: analog_update_cuda(*views, out=views[0], **kw), 3, 5)
    print(f"kernels: analog_update_ (in place) {MOE_STACK} bfloat16: "
          f"bit-equal to the out-of-place kernel={same}; median device "
          f"{ki * 1e3:.2f} us, per call {ki_call * 1e3:.2f} us (memory bound "
          f"{bound * 1e3:.2f} us, {bound / ki:.0%} of it reached)")
    pi, _ = time_ms(lambda: w.copy_(ref.analog_update_ref(*operands, **kw)),
                    2, 3)
    del operands, views, w, dw, gamma, rho
    gc.collect()
    torch.cuda.empty_cache()
    return (dict(ms=k, plain_ms=p, bound_ms=bound, shape=list(MOE_STACK),
                 dtype="bfloat16"),
            dict(ms=ki, plain_ms=pi, bound_ms=bound, max_abs_err=err,
                 shape=list(MOE_STACK), dtype="bfloat16"))


# K1's hash-noise mode and the hash normal draw (csrc/fastrng.cuh): the
# integer and float operations an element (kernels/fastrng.py counts them
# from the source) against the card's 67 TFLOP/s outside the tensor cores
HASH_UPDATE_OPS = 30 + 22 + 62
HASH_NORMAL_OPS = 62
HASH_SALTS = (2, 11, 13, 17)
# DeviceConfig fields of phase 3's device draws: the training CLI's W and
# P (launch/train.py) and one without sigma_d2d (gamma 1)
HASH_DEVICES = {
    "dev_w": dict(sigma_d2d=0.1, sigma_pm=0.3),
    "dev_p": dict(sigma_d2d=0.1, sigma_pm=0.3, ref_mean=0.1, ref_std=0.1),
    "no_d2d": dict(sigma_d2d=0.0, sigma_pm=0.3)}


# The issue bound (benchmarks/sass_count.py): the SASS instructions an
# element of each kernel in this run's build, issued at 128 a clock on each
# of the 132 SMs at the card's clocks.max.sm
SASS_COUNTS = {"clock_mhz": None, "kernels": {}}


def sass_counts() -> None:
    """Counts the SASS of K1's and the hash kernels' libraries as built for
    this run, prints each kernel's instructions an element by class and its
    registers, and keeps them in SASS_COUNTS."""
    from repro_torch.benchmarks import sass_count
    from repro_torch.kernels import cuda_build

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    SASS_COUNTS["clock_mhz"] = float(out.stdout.split()[0])
    for name in ("analog_update", "fastrng"):
        SASS_COUNTS["kernels"].update(sass_count.count_library(
            str(cuda_build.library_path(name))))
    for label, e in sorted(SASS_COUNTS["kernels"].items()):
        by = ", ".join(f"{k} {v:.2f}"
                       for k, v in e["per_element_by_class"].items())
        print(f"kernels: SASS {label}: {e['per_element']:.2f} instructions "
              f"an element ({by}), {e['registers']} registers, "
              f"{e['static']} in all")


def issue_ms(label: str, numel: int) -> float:
    """The issue bound of ``numel`` elements of kernel ``label``, ms."""
    from repro_torch.benchmarks import sass_count

    e = SASS_COUNTS["kernels"][label]
    return sass_count.issue_us(e["per_element"], numel,
                               SASS_COUNTS["clock_mhz"]) / 1e3


def k1_label(w_dtype, dw_dtype, hash_mode: bool) -> str:
    short = {"torch.float32": "f32", "torch.bfloat16": "bf16"}
    return (f"analog_update{'_hash' if hash_mode else ''}"
            f"<w {short[str(w_dtype)]}, dw {short[str(dw_dtype)]}>")


def k1_configs():
    """(dw_min, tau_min, tau_max, sigma_c2c) of every device config the
    repo gives K1: phase 3's, path_ab.py's, core/device.py's presets, the
    training CLI's P and W (smoke and full), the paper harness's defaults
    and its Tables device, the dataclass default."""
    from repro_torch.benchmarks.common import device_pair
    from repro_torch.core.device import PRESETS, DeviceConfig
    from repro_torch.launch.train import make_tile_cfg

    cfgs = [DeviceConfig(), *PRESETS.values(), *device_pair(),
            *device_pair(**TABLES_DEVICE)]
    for smoke in (True, False):
        t = make_tile_cfg("erider", smoke)
        cfgs += [t.device_p, t.device_w]
    out = {(0.01, 1.0, 1.0, 0.1), (1e-3, 0.9, 1.1, 0.05)}
    out |= {(c.dw_min, c.tau_min, c.tau_max, c.sigma_c2c) for c in cfgs}
    return sorted(out)


# the divisors (d, r, hi) and noise scales already swept, and the K1
# launch scalars the script's launches used (recorded from phase 3 on)
SWEPT = {"div": {}, "sqrt": {}}
K1_LAUNCHED = set()
# divisors drawn at random over the fast division's range, beyond the
# configs': any significand, exponents from -32 to 31
RANDOM_DIVISORS = 24


def record_k1_launches() -> None:
    """Records every K1 launch's (dw_min, tau_min, tau_max, sigma_c2c), so
    that the end of the script sweeps any the configs did not name."""
    from repro_torch.kernels import analog_update

    base = analog_update.launch_scalars

    def recorded(dw_min, tau_min, tau_max, sigma_c2c, bl=0):
        K1_LAUNCHED.add((float(dw_min), float(tau_min), float(tau_max),
                         float(sigma_c2c)))
        return base(dw_min, tau_min, tau_max, sigma_c2c, bl)

    analog_update.launch_scalars = recorded


def exact_sweeps(configs, label: str = "kernels") -> dict:
    """The exhaustive checks of the kernels' exact rewrites, on check
    kernels only this script launches: each divisor of ``configs``
    (dw_min, tau_min, tau_max, with the reciprocal and range the wrapper
    computes) over all 2^32 float32 x, div_fast where div_ok and the IEEE
    division elsewhere, against __fdiv_rn; each noise scale's square-root
    table against noise_scale * sqrtf for every whole |n_q| < 2^24, inf and
    NaN; the first call also ``RANDOM_DIVISORS`` divisors drawn from a
    fixed seed, and every mantissa through the normal's division
    (fastrng.cuh, log_div). Each must show 0 mismatches (two NaNs agree).
    One line a check."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.analog_update import launch_scalars

    lib = cuda_build.load("analog_update")
    div = lib.analog_update_div_sweep
    div.argtypes = [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
    sq = lib.analog_update_sqrt_sweep
    sq.argtypes = [ctypes.c_float] + [ctypes.c_void_p] * 2
    stream = torch.cuda.current_stream().cuda_stream
    t0 = time.time()

    def counts(n, launch):
        c = torch.zeros(n, dtype=torch.int64, device="cuda")
        check(launch(c.data_ptr()) == 0, "an exact-rewrite check kernel "
                                         "did not launch")
        torch.cuda.synchronize()
        return c.tolist()

    def sweep(d, r, hi, what):
        key = (float(d), float(r), float(hi))
        if key in SWEPT["div"]:
            return
        bad, fast, first = counts(3, lambda p: div(d, r, hi, p, stream))
        SWEPT["div"][key] = bad
        print(f"{label}: exact division by {float(d)!r} ({what}, reciprocal "
              f"{float(r)!r}): all 2^32 float32 x, {fast} through div_fast, "
              f"{bad} mismatches against __fdiv_rn")
        check(bad == 0, f"div_fast differs from __fdiv_rn for divisor "
                        f"{float(d)!r} (first x bits "
                        f"{first & 0xFFFFFFFF:#010x})")

    for cfg in configs:
        s = launch_scalars(*cfg)
        for d, r, hi in ((s[0], s[1], s[8]), (s[2], s[3], s[9]),
                         (s[4], s[5], s[9])):
            sweep(d, r, hi, "a config's")
        ns = float(s[6])
        if ns not in SWEPT["sqrt"]:
            bad, hits = counts(2, lambda p: sq(ns, p, stream))
            SWEPT["sqrt"][ns] = bad
            print(f"{label}: square-root table, noise scale {ns!r}: every "
                  f"whole |n_q| < 2^24 of both signs, inf and NaN, {hits} "
                  f"read from the table, {bad} mismatches")
            check(bad == 0, f"the square-root table differs for noise scale "
                            f"{ns!r}")
    if "log_div_mismatches" not in SWEPT:
        rng = np.random.default_rng(31)
        bits = ((rng.integers(127 - 32, 127 + 32, RANDOM_DIVISORS) << 23)
                | rng.integers(0, 1 << 23, RANDOM_DIVISORS))
        for d in bits.astype(np.uint32).view(np.float32):
            s = launch_scalars(float(d), 1.0, 1.0, 0.1)
            sweep(s[0], s[1], s[8], "drawn at random")
        fl = cuda_build.load("fastrng").fastrng_log_div_sweep
        fl.argtypes = [ctypes.c_void_p] * 2
        bad, first = counts(2, lambda p: fl(p, stream))
        SWEPT["log_div_mismatches"] = bad
        print(f"{label}: the normal's division 1.72587999 / (mant + "
              f"0.3520887068): all 2^23 mantissas, {bad} mismatches against "
              f"__fdiv_rn")
        check(bad == 0, f"log_div differs from __fdiv_rn (first mantissa "
                        f"{first & 0xFFFFFFFF:#x})")
    out = dict(divisors=len(SWEPT["div"]), random_divisors=RANDOM_DIVISORS,
               div_mismatches=sum(SWEPT["div"].values()),
               sqrt_scales=len(SWEPT["sqrt"]),
               sqrt_mismatches=sum(SWEPT["sqrt"].values()),
               log_div_mismatches=SWEPT["log_div_mismatches"])
    print(f"{label}: exact-rewrite checks took {time.time() - t0:.1f} s")
    return out


def hash_keys(shape, seed: int):
    """(key, n) for K1's hash-noise mode at ``shape``: one host key for a
    2-D tile, one a member (the leading dims flattened) for a stack of
    rank 3 or more; words past 2**31 included."""
    import numpy as np
    import torch

    n = math.prod(shape[:-2]) if len(shape) >= 3 else 1
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, size=(n, 2),
                                         dtype=np.uint64).astype(np.int64))
    return (keys[0] if n == 1 else keys), n


def hash_noise_plain(key, shape, device):
    """The eager hash draws of ``key`` at ``shape`` (salts 1 and 2, the index
    restarting per member): the operands K1's hash mode draws itself."""
    from repro_torch.kernels import fastrng

    seeds = fastrng.device_seeds(fastrng.seed_from_key(key),
                                 "cpu").reshape(-1, 2)
    return (fastrng.member_draw(fastrng.hash_bits, seeds, shape, 1, device),
            fastrng.member_draw(fastrng.hash_normal_ref, seeds, shape, 2,
                                device))


def events_ms(fn, reps: int, rounds: int) -> float:
    """Device ms per call of ``fn`` issued eagerly (CUDA events around
    ``reps`` calls, median of ``rounds``): for plain versions that read
    host seeds, which a CUDA graph cannot capture."""
    import torch

    fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def hash_update_check(shape, dtype, bl, seed, device, kw, operands=None):
    """K1's hash-noise mode through ``ops.analog_update(rng="hash")``, out
    of place and in place, against the operand mode fed the eager draws:
    bit-equal. Returns the largest |difference|."""
    import torch

    from repro_torch.kernels import ops

    w, dw, gamma, rho = operands or update_operands(
        shape, dtype, seed, device, torch.float32)
    key, n = hash_keys(shape, seed)
    noise = hash_noise_plain(key, shape, device)
    want = ops.analog_update(w, dw, gamma, rho, None, noise=noise, bl=bl,
                             **kw)
    del noise
    before = dict(ops.LAUNCHES)
    got = ops.analog_update(w, dw, gamma, rho, key, rng="hash", bl=bl, **kw)
    w2 = w.clone()
    ops.analog_update(w2, dw, gamma, rho, key, rng="hash", bl=bl, out=w2,
                      **kw)
    torch.cuda.synchronize()
    for name, more in (("analog_update_hash", 2), ("analog_update_", 1)):
        check(ops.LAUNCHES[name] == before[name] + more,
              f"the wrapper did not launch K1's hash mode ({name}) at "
              f"{shape}")
    same = torch.equal(got, want) and torch.equal(w2, want)
    err = max((got.float() - want.float()).abs().max().item(),
              (w2.float() - want.float()).abs().max().item())
    print(f"kernels: analog_update_hash {shape} "
          f"{str(w.dtype).replace('torch.', '')} bl={bl} {n} seed(s): out "
          f"of place and in place bit-equal to the operand mode fed the "
          f"eager draws={same} max_abs_diff={err:.3g}")
    check(same, f"K1's hash mode differs from the operand mode at {shape} "
                f"{w.dtype} bl={bl}")
    return err


def hash_update_timed(shape, dtype, device, kw, reps, rounds, operands=None):
    """K1's hash mode alone (its binding, device seeds) out of place and in
    place, the plain version (the eager draws and the plain update) and the
    bound: (2 * w bytes + 12) B and HASH_UPDATE_OPS an element."""
    import torch

    from repro_torch.kernels import fastrng, ops
    from repro_torch.kernels.analog_update import analog_update_hash_cuda

    w, dw, gamma, rho = operands or update_operands(
        shape, dtype, 9, device, torch.float32)
    key, n = hash_keys(shape, 9)
    host = fastrng.device_seeds(fastrng.seed_from_key(key),
                                "cpu").reshape(-1, 2)
    seeds = host.to(device)
    k, k_call = time_ms(lambda: analog_update_hash_cuda(
        w, dw, gamma, rho, seeds, bl=10, **kw), reps, rounds)
    ki, ki_call = time_ms(lambda: analog_update_hash_cuda(
        w, dw, gamma, rho, seeds, bl=10, out=w, **kw), reps, rounds)
    p = events_ms(lambda: ops._hash_update_ref(w, dw, gamma, rho, host,
                                               bl=10, **kw),
                  max(1, reps // 4), max(3, rounds // 3))
    numel = math.prod(shape)
    wb = torch.finfo(w.dtype).bits // 8
    t_bytes = ((2 * wb + 12) * numel + 8 * n) / H100_BYTES_PER_S
    t_ops = HASH_UPDATE_OPS * numel / H100_F32_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    issue = issue_ms(k1_label(w.dtype, dw.dtype, True), numel)
    print(f"kernels: analog_update_hash {shape} "
          f"{str(w.dtype).replace('torch.', '')} {n} seed(s): median device "
          f"{k * 1e3:.2f} us, per call {k_call * 1e3:.2f} us; in place "
          f"{ki * 1e3:.2f} us, per call {ki_call * 1e3:.2f} us (plain, the "
          f"eager draws and update: {p * 1e3:.2f} us; bound "
          f"{bound * 1e3:.2f} us by {by}: {t_bytes * 1e6:.2f} us of bytes, "
          f"{t_ops * 1e6:.2f} us of operations at 67 TFLOP/s; "
          f"{bound / k:.0%} / {bound / ki:.0%} of it reached; issue bound "
          f"{issue * 1e3:.2f} us)")
    entry = dict(plain_ms=p, bound_ms=bound, bound_by=by,
                 bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3, issue_ms=issue,
                 shape=list(shape), dtype=str(w.dtype).replace("torch.", ""),
                 seeds=n)
    return dict(entry, ms=k), dict(entry, ms=ki)


# Shapes whose members take the kernels' scalar loop: a tile of 3201
# elements (800 groups of 4 and one left) and 4 members of 3201 (only the
# first 16-byte aligned); then views one element past a buffer's start.
SCALAR_PATH_SHAPES = [(33, 97), (4, 33, 97)]


def scalar_path_checks(device, kw) -> float:
    """K1 in both modes (in and out of place), ``hash_normal`` and
    ``hash_device`` where the vector path cannot take a member whole:
    bit-equal to their plain versions. Returns the largest |difference|."""
    import torch

    from repro_torch import prng
    from repro_torch.benchmarks.common import offset_view
    from repro_torch.core.device import DeviceConfig
    from repro_torch.kernels import fastrng, ops, ref
    from repro_torch.kernels.ref import device_scalars

    err = 0.0
    for i, (shape, dtype, offset) in enumerate(
            (s, dt, o) for s in SCALAR_PATH_SHAPES
            for dt in (torch.float32, torch.bfloat16) for o in (0, 1)):
        operands = update_operands(shape, dtype, 120 + i, device,
                                   torch.float32)
        if offset:
            operands = tuple(offset_view(t) for t in operands)
        noise = ops.make_noise(prng.PRNGKey(130 + i), shape, device, "hash")
        got = ops.analog_update(*operands, None, noise=noise, bl=10, **kw)
        want = ref.analog_update_ref(*operands, *noise, bl=10, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 differs from plain at {shape} "
                                      f"{dtype}, offset {offset}")
        err = max(err, hash_update_check(shape, dtype, 10, 140 + i, device,
                                         kw, operands))
    shape = SCALAR_PATH_SHAPES[1]
    key, _ = hash_keys(shape, 150)
    seed = fastrng.seed_from_key(key)
    for salt in (2, 17):
        got = fastrng.hash_normal(seed, shape[1:], salt, device)
        want = fastrng.hash_normal_ref(seed, shape[1:], salt, device)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"hash_normal differs at {shape}")
    seeds = fastrng.device_seeds(seed, device)
    for name, fields in HASH_DEVICES.items():
        sc = device_scalars(DeviceConfig(**fields))
        gamma = torch.empty(shape, device=device)
        rho = torch.empty_like(gamma)
        fastrng.hash_device_cuda(seeds, gamma, rho, **sc)
        want = fastrng.hash_device_ref(seeds, shape, device, **sc)
        torch.cuda.synchronize()
        check(torch.equal(gamma, want[0]) and torch.equal(rho, want[1]),
              f"hash_device differs at {shape} ({name})")
    print(f"kernels: the scalar path (members of 3201, views one element "
          f"off): K1 both modes, hash_normal, hash_device bit-equal to "
          f"their plain versions")
    return err


def phase_kernels_hash(device):
    """Phase 3 for the Hopper form of ``kernels/fastrng.py``: K1's
    hash-noise mode bit-equal to its operand mode fed the eager draws at
    SWEEP_SHAPES (f32, bf16), MAIN_PATH_SHAPES (f32), LM_PATH_SHAPES (bf16
    w, f32 dw; one seed a tile as the CLI draws, and one a member) and the
    4-D MoE stack (bf16, a seed an expert); ``repro_torch::hash_normal``
    bit-equal to the eager chain for the salts of the update and the
    device draw on Qwen2-0.5B's largest stack; each timed against its
    bound. Returns the JSON entries' numbers."""
    import gc

    import torch

    from repro_torch.kernels import fastrng, ops

    kw = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1)
    t0 = time.time()
    exact = exact_sweeps(k1_configs())
    err = 0.0
    cases = [(s, dt, bl) for s in SWEEP_SHAPES
             for dt in (torch.float32, torch.bfloat16) for bl in (0, 10)]
    cases += [(s, torch.float32, bl) for s in MAIN_PATH_SHAPES
              for bl in (0, 10)]
    cases += [(s, torch.bfloat16, 0) for s in LM_PATH_SHAPES]
    for i, (shape, dtype, bl) in enumerate(cases):
        err = max(err, hash_update_check(shape, dtype, bl, 40 + i, device,
                                         kw))
    err = max(err, scalar_path_checks(device, kw))
    # the CLI's draw on the LM stacks: one seed for the whole tile
    for i, shape in enumerate(LM_PATH_SHAPES[:4]):
        w, dw, gamma, rho = update_operands(shape, torch.bfloat16, 80 + i,
                                            device, torch.float32)
        key, _ = hash_keys(shape[-2:], 80 + i)
        noise = hash_noise_plain(key, shape, device)
        want = ops.analog_update(w, dw, gamma, rho, None, noise=noise, **kw)
        got = ops.analog_update(w, dw, gamma, rho, key, rng="hash", **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"kernels: analog_update_hash {shape} bfloat16, one seed for "
              f"the tile (the CLI's): bit-equal={same}")
        check(same, f"K1's hash mode differs at {shape} with one seed")
        del w, dw, gamma, rho, noise, want, got
    # the 4-D MoE stack, a seed an expert
    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    moe = ((torch.rand(MOE_STACK, generator=gen, device=device) * 1.6
            - 0.8).to(torch.bfloat16),
           0.05 * torch.randn(MOE_STACK, generator=gen, device=device),
           torch.exp(0.1 * torch.randn(MOE_STACK, generator=gen,
                                       device=device)),
           0.3 * torch.randn(MOE_STACK, generator=gen, device=device))
    err = max(err, hash_update_check(MOE_STACK, torch.bfloat16, 0, 29,
                                     device, kw, moe))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"kernels: K1's hash mode, {len(cases) + 5} shapes, bit-equal to "
          f"the operand mode in and out of place ({time.time() - t0:.1f} s)")

    fcn, fcn_ip = hash_update_timed((784, 256), torch.float32, device, kw,
                                    20, 15)
    l2, l2_ip = hash_update_timed((896, 4864), torch.float32, device, kw,
                                  20, 15)
    stack, stack_ip = hash_update_timed(LM_PATH_SHAPES[2], torch.bfloat16,
                                        device, kw, 3, 5)
    moe_t, moe_ip = hash_update_timed(MOE_STACK, torch.bfloat16, device, kw,
                                      3, 5, moe)
    del moe
    gc.collect()
    torch.cuda.empty_cache()

    # the hash normal draw: the update's salt and the device draw's, on
    # Qwen2-0.5B's largest stack with a seed a layer and with one seed (the
    # CLI's sample_device), bit-equal to the eager chain on the card
    member = LM_PATH_SHAPES[2][1:]
    for n in (LM_PATH_SHAPES[2][0], 1):
        key, _ = hash_keys((n,) + member if n > 1 else member, 50 + n)
        seed = fastrng.seed_from_key(key)
        shape = LM_PATH_SHAPES[2][1:] if n > 1 else LM_PATH_SHAPES[2]
        for salt in HASH_SALTS:
            before = ops.LAUNCHES["hash_normal"]
            got = fastrng.hash_normal(seed, shape, salt, device)
            check(ops.LAUNCHES["hash_normal"] == before + 1,
                  "fastrng.hash_normal did not launch its kernel")
            want = fastrng.hash_normal_ref(seed, shape, salt, device)
            torch.cuda.synchronize()
            same = (got.shape == want.shape and torch.equal(got, want))
            e = (got - want).abs().max().item()
            err = max(err, e)
            print(f"kernels: hash_normal {tuple(got.shape)} {n} seed(s) "
                  f"salt {salt}: bit-equal to the eager chain={same} "
                  f"max_abs_diff={e:.3g}")
            check(same, f"hash_normal differs from the eager chain at "
                        f"salt {salt}, {n} seed(s)")
            del got, want
    normal = {}
    for shape, reps, rounds in (((896, 4864), 20, 15),
                                (LM_PATH_SHAPES[2], 3, 5)):
        key, n = hash_keys(shape[-2:], 60)
        host = fastrng.device_seeds(fastrng.seed_from_key(key),
                                    "cpu").reshape(-1, 2)
        seeds = host.to(device)
        out = torch.empty(shape, device=device)
        k, k_call = time_ms(lambda: fastrng.hash_normal_cuda(seeds, out, 11),
                            reps, rounds)
        p = events_ms(lambda: fastrng.hash_normal_ref(host[0], shape, 11,
                                                      device),
                      max(1, reps // 4), max(3, rounds // 3))
        numel = math.prod(shape)
        t_bytes = (4 * numel + 8) / H100_BYTES_PER_S
        t_ops = HASH_NORMAL_OPS * numel / H100_F32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        issue = issue_ms("hash_normal", numel)
        print(f"kernels: hash_normal {shape}: median device {k * 1e3:.2f} "
              f"us, per call {k_call * 1e3:.2f} us (plain, the eager chain: "
              f"{p * 1e3:.2f} us; bound {bound * 1e3:.2f} us by {by}: "
              f"{t_bytes * 1e6:.2f} us of bytes, {t_ops * 1e6:.2f} us of "
              f"operations at 67 TFLOP/s; {bound / k:.0%} of it reached; "
              f"issue bound {issue * 1e3:.2f} us)")
        normal[len(shape)] = dict(ms=k, plain_ms=p, bound_ms=bound,
                                  bound_by=by, bytes_ms=t_bytes * 1e3,
                                  ops_ms=t_ops * 1e3, issue_ms=issue,
                                  shape=list(shape))
        del out
    drawn = hash_device_phase(device)
    print(f"kernels: the hash kernels' phase took {time.time() - t0:.1f} s")
    update = dict(max_abs_err=err, **fcn, beyond_l2=l2, lm_stack=stack,
                  moe_stack=moe_t,
                  in_place=dict(fcn_ip, beyond_l2=l2_ip, lm_stack=stack_ip,
                                moe_stack=moe_ip),
                  exact_checks=exact,
                  sass=dict(clock_mhz=SASS_COUNTS["clock_mhz"], kernels={
                      k: dict(per_element=e["per_element"],
                              registers=e["registers"])
                      for k, e in SASS_COUNTS["kernels"].items()}))
    return (update, dict(max_abs_err=err, **normal[2], lm_stack=normal[3]),
            drawn)


def float_ulps(a, b) -> int:
    """The largest distance of two float32 tensors in ULPs (signs apart)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max().item())


def hash_device_phase(device):
    """``repro_torch::hash_device`` (``sample_device(method="hash")``, one
    launch a draw) bit-equal to its plain version, the eager chain on the
    card (``fastrng.hash_device_ref``), for HASH_DEVICES at (896, 4864)
    with one seed and (24, 896, 4864) with 24 seeds and with one (the
    CLI's draw of a stack); then timed at both shapes with one seed
    against its bound: 8 B an element written (8 B a seed read) and
    ``op_cost.device_draw_ops`` an element. Returns the JSON entry's
    numbers, the top level ``dev_p`` at (896, 4864)."""
    import gc

    import torch

    from repro_torch.core.device import DeviceConfig, sample_device
    from repro_torch.kernels import fastrng, ops
    from repro_torch.kernels.ref import device_scalars
    from repro_torch.roofline.op_cost import device_draw_ops

    stack = LM_PATH_SHAPES[2]
    err = 0.0
    for shape, n in ((stack[1:], 1), (stack, stack[0]), (stack, 1)):
        key, _ = hash_keys(shape if n > 1 else shape[-2:],
                           70 + len(shape) + n)
        member = shape[1:] if n > 1 else shape
        for name, fields in HASH_DEVICES.items():
            cfg = DeviceConfig(**fields)
            before = dict(ops.LAUNCHES)
            got = sample_device(key, member, cfg, method="hash",
                                device=device)
            check(ops.LAUNCHES["hash_device"] == before["hash_device"] + 1
                  and ops.LAUNCHES["hash_normal"] == before["hash_normal"],
                  f"sample_device did not launch hash_device once ({name})")
            want = fastrng.hash_device_ref(
                fastrng.device_seeds(fastrng.seed_from_key(key), device),
                shape, device, **device_scalars(cfg))
            torch.cuda.synchronize()
            same = all(got[k].shape == w.shape and torch.equal(got[k], w)
                       for k, w in zip(("gamma", "rho"), want))
            ulps = [float_ulps(got[k], w)
                    for k, w in zip(("gamma", "rho"), want)]
            e = max((got[k] - w).abs().max().item()
                    for k, w in zip(("gamma", "rho"), want))
            err = max(err, e)
            print(f"kernels: hash_device {shape} {n} seed(s) {name}: "
                  f"bit-equal to the eager chain={same} (ULPs gamma "
                  f"{ulps[0]}, rho {ulps[1]}; max_abs_diff {e:.3g})")
            check(same, f"hash_device differs from the eager chain at "
                        f"{shape}, {n} seed(s), {name}")
            del got, want
            gc.collect()
            torch.cuda.empty_cache()
    out = {}
    for shape, reps, rounds in ((stack[1:], 20, 15), (stack, 3, 5)):
        key, _ = hash_keys(shape[-2:], 90)
        host = fastrng.device_seeds(fastrng.seed_from_key(key),
                                    "cpu").reshape(-1, 2)
        seeds = host.to(device)
        numel = math.prod(shape)
        gamma = torch.empty(shape, device=device)
        rho = torch.empty_like(gamma)
        for name, fields in HASH_DEVICES.items():
            scalars = device_scalars(DeviceConfig(**fields))
            per = device_draw_ops(scalars["sigma_d2d"], scalars["ref_mean"],
                                  scalars["ref_std"])
            k, k_call = time_ms(lambda: fastrng.hash_device_cuda(
                seeds, gamma, rho, **scalars), reps, rounds)
            p = events_ms(lambda: fastrng.hash_device_ref(
                host, shape, device, **scalars), max(1, reps // 4),
                max(3, rounds // 3))
            t_bytes = (8 * numel + 8) / H100_BYTES_PER_S
            t_ops = per * numel / H100_F32_FLOPS
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes >= t_ops else "operations"
            issue = issue_ms(f"hash_device<{name}>", numel)
            print(f"kernels: hash_device {shape} {name}: median device "
                  f"{k * 1e3:.2f} us, per call {k_call * 1e3:.2f} us "
                  f"(plain, the eager chain: {p * 1e3:.2f} us; bound "
                  f"{bound * 1e3:.2f} us by {by}: {t_bytes * 1e6:.2f} us of "
                  f"bytes, {t_ops * 1e6:.2f} us of {per} operations an "
                  f"element at 67 TFLOP/s; {bound / k:.0%} of it reached; "
                  f"issue bound {issue * 1e3:.2f} us)")
            out.setdefault(name, {})[len(shape)] = dict(
                ms=k, call_ms=k_call, plain_ms=p, bound_ms=bound,
                bound_by=by, bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
                issue_ms=issue, shape=list(shape))
        del gamma, rho
        gc.collect()
        torch.cuda.empty_cache()
    return dict(max_abs_err=err, **out["dev_p"][2],
                lm_stack=out["dev_p"][3],
                configs={name: dict(tile=v[2], lm_stack=v[3])
                         for name, v in out.items()})


def hash_launches(label: str, drawn: bool) -> dict:
    """The hash kernels' counts since the last reset: every K1 launch of a
    hash-noise step in the hash mode, and no ``hash_normal`` launch (K1
    draws the noise, ``hash_device`` the devices); ``drawn``
    (``store_device=False``): one ``hash_device`` launch a K1 launch, the
    device of the array it updates, and none otherwise."""
    from repro_torch.kernels import ops

    k1 = ops.LAUNCHES["analog_update"]
    h = ops.LAUNCHES["analog_update_hash"]
    z = ops.LAUNCHES["hash_normal"]
    d = ops.LAUNCHES["hash_device"]
    print(f"{label}: K1 launches {k1}, in its hash-noise mode {h}; "
          f"hash_device launches {d}, hash_normal launches {z}")
    check(h == k1 and h > 0, f"{label}: {h} of {k1} K1 launches in the "
          f"hash-noise mode")
    check(z == 0, f"{label}: {z} hash_normal launches in training steps")
    check(d == (h if drawn else 0), f"{label}: {d} hash_device launches, "
          f"not {'one a K1 launch' if drawn else 'none'}")
    return dict(hash=h, normal=z, device=d)


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
FCN_HASH = {}   # K1's hash-mode launches of phase 7 by backend


def fcn_snapshot(state, metrics):
    """Loss, tile W per class and digital biases, on the host."""
    return dict(loss=float(metrics["loss"]),
                W={c: st["W"].detach().cpu().clone()
                   for c, st in state["tiles"].classes.items()},
                b={k: state["params"][k]["b"].detach().cpu().clone()
                   for k in ("fc1", "fc2", "out")})


def phase_fcn(device, backend: str, steps: int = 30):
    """The donated step (``trainer.jit_step()``, the main path) for
    ``steps`` steps, every K1 launch in place; then the same steps out of
    place from a copy of the initial state: every leaf and every step's
    loss bit-equal. Returns (K1 launches, median ms/step)."""
    import torch

    from repro_torch.benchmarks.common import fcn_run
    from repro_torch.core.paths import flatten_with_path, tree_map
    from repro_torch.kernels import ops

    trainer, state, batches = fcn_run(backend, device, steps)
    pure = tree_map(torch.clone, state)
    ptrs = {p: t.untyped_storage().data_ptr()
            for p, t in flatten_with_path(state)}
    step = trainer.jit_step()
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    losses, step_ms, card = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if len(card) < FCN_CHECK_STEPS:
            card.append(fcn_snapshot(state, m))
    launches = ops.LAUNCHES["analog_update"]
    in_place = ops.LAUNCHES["analog_update_"]
    check(in_place == launches, f"fcn[{backend}]: {in_place} of {launches} "
          f"K1 launches in place")
    if backend == "fused":  # the batched update's hash noise, in the kernel
        hashed = hash_launches(f"fcn[{backend}]", False)["hash"]
    else:
        hashed = ops.LAUNCHES["analog_update_hash"]
        check(hashed == 0, f"fcn[{backend}]: threefry steps launched K1's "
              f"hash mode")
    FCN_HASH[backend] = hashed
    moved = [p for p, t in flatten_with_path(state)
             if t.untyped_storage().data_ptr() != ptrs[p]]
    check(not moved, f"fcn[{backend}]: leaves not kept in place: {moved}")
    pure_losses = []
    for b in batches:
        pure, m = trainer.train_step(pure, b)
        pure_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    n = leaves_equal(state, pure, f"fcn[{backend}] donated against pure")
    check(losses == pure_losses, f"fcn[{backend}]: donated losses differ")
    print(f"fcn[{backend}]: {steps} donated steps (every K1 launch in place, "
          f"every leaf on its storage) bit-equal to {steps} out-of-place "
          f"steps on all {n} leaves and every loss")
    del pure
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
    (the FCN, through the donated step: the asynchronous save's host copy
    must not see the steps after it); then the save and restore rates of a
    tile state at LM scale. Returns a copy of the state restored at step 5
    (run B writes the restore in place) and the manifest's signatures."""
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
    step_a = trainer.jit_step()
    for step in range(CKPT_STEPS):
        state, m = step_a(state, next(feed))
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
    # run B's donated steps write the restore in place; phase 9 reads the
    # state at step 5, so it gets a copy
    kept = tree_map(lambda t: t.clone(), restored)
    resumed = restored
    feed = Prefetcher(producer, CKPT_AT, depth=2, device=device)
    ops.reset_launch_counts()
    step_b = trainer_b.jit_step()
    for _ in range(CKPT_AT, CKPT_STEPS):
        resumed, _ = step_b(resumed, next(feed))
    launches = ops.LAUNCHES["analog_update"]
    check(ops.LAUNCHES["analog_update_"] == launches,
          "ckpt: run B's K1 launches not all in place")
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
    # the copy phase 9 reads is still the step-5 state
    leaves_equal(kept, saved, "copy of the step-5 restore after run B")

    lm_ckpt(device, os.path.join(root, "lm"))
    return trainer_b, kept, sig0


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
    in_place = ops.LAUNCHES["analog_update_"]
    hashed = hash_launches("lm", True)
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
    print(f"lm: {hashed['device'] / LM_STEPS:g} hash_device and "
          f"{hashed['normal'] / LM_STEPS:g} hash_normal launches a step")
    print(f"lm: median {med:.2f} ms/step (host clock, synchronized, first "
          f"step dropped), peak allocated {peak / 2 ** 30:.3f} GiB "
          f"({before / 2 ** 30:.3f} GiB before, {resident / 2 ** 30:.3f} GiB "
          f"held by the final state), tile state {tbytes} bytes, the CLI's "
          f"donated step ({in_place} of {launches} K1 launches in place; "
          f"phase 18 (b) holds one step's peak to the dry run's), on {card}")
    check(launches == 2 * n_paths * LM_STEPS,
          f"lm launches {launches} != {2 * n_paths * LM_STEPS}")
    check(in_place == launches, f"lm: {in_place} of {launches} K1 launches "
          f"in place")
    check(tail < losses[0], "lm loss did not fall")
    return dict(launches=launches, in_place=in_place, step_ms=med,
                peak_bytes=peak, tile_bytes=tbytes, losses=losses,
                hash_launches=hashed["hash"],
                normal_launches=hashed["normal"],
                device_launches=hashed["device"])


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

    from repro_torch.kernels import ops

    argv = LM_SMOKE_ARGV + ["--steps", str(LM_CHECK_STEPS), "--tiles", tiles]
    ops.reset_launch_counts()
    card, card_hist, _ = run_cli(argv + ["--device", "cuda"])
    if tiles == "full":  # hash noise: K1's hash mode, the normal kernel
        hash_launches(f"lm[{tiles}]", True)
    else:
        check(ops.LAUNCHES["analog_update_hash"] == 0
              and ops.LAUNCHES["hash_normal"] == 0
              and ops.LAUNCHES["hash_device"] == 0,
              f"lm[{tiles}]: threefry steps launched the hash kernels")
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
# ids, 4 steps; Mamba2 at seq 512, so SSD runs two chunks of 256. (a)
# also restarts the CLI on the card, bit-equal, for one arch of each new
# family (MoE, MLA, SSD).
LM_ZOO = ["mixtral-8x7b", "deepseek-v2-236b", "minicpm3-4b",
          "recurrentgemma-9b", "mamba2-2.7b", "seamless-m4t-large-v2"]
ZOO_BATCH, ZOO_SEQ = 4, 80
ZOO_RESTART = ["mixtral-8x7b", "minicpm3-4b", "mamba2-2.7b"]
FULL_WIDTH = [("minicpm3-4b", 128), ("mamba2-2.7b", 512)]
FULL_LAYERS, FULL_BATCH, FULL_STEPS = 8, 8, 4


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
    (median over steps 2-4, host clock, synchronized), the peak allocated
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
    hashed = hash_launches(f"lm[{arch}]", True)
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
          f"({launches / FULL_STEPS:g} per step), "
          f"{hashed['device'] / FULL_STEPS:g} hash_device and "
          f"{hashed['normal'] / FULL_STEPS:g} hash_normal launches a step")
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
                seq=seq, hash_launches=hashed["hash"],
                normal_launches=hashed["normal"],
                device_launches=hashed["device"])


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

# Phase 12: serving. (a) The five page-pool smoke archs (qwen2-0.5b,
# qwen3-14b, gemma3-4b, qwen2-vl-2b, mixtral-8x7b) on the workload of the
# reference's tests/test_serving_engine.py (5 requests, prompt 10, gen 4+-2,
# 2 lanes, page 4, a common 8-token prefix, chunk 8, prefix sharing), and
# gemma3 with a prompt longer than its 16-token window. (b) Qwen2-0.5B at
# full width and depth (src/repro/configs/qwen2_0_5b.py), trained for 2
# steps by the CLI (phase 10's argv), checkpointed, then served by the
# serve CLI from that checkpoint aged one year and drift-compensated: 16
# requests, prompt 128, gen 32, the dense family's defaults (8 lanes, page
# 16, chunk 64), prompts over the first 8192 ids; and again through the
# fixed-batch driver, batch 8.
SERVE_ARCHS = ["qwen2-0.5b", "qwen3-14b", "gemma3-4b", "qwen2-vl-2b",
               "mixtral-8x7b"]
SERVE_CASES = [(a, 10) for a in SERVE_ARCHS] + [("gemma3-4b", 24)]
SERVE_STEPS = 2
SERVE_ARGV = ["--arch", "qwen2-0.5b", "--algorithm", "erider", "--age", "1yr",
              "--gdc", "on", "--requests", "16", "--prompt-len", "128",
              "--gen", "32", "--data-vocab", "8192", "--device", "cuda"]
SERVE_BATCH, SERVE_GEN = 8, 32


def serve_smoke_run(arch: str, prompt_len: int, params, model):
    """(fixed tokens, continuous tokens, prefill signatures) of one smoke
    case on the device of ``params``."""
    from repro_torch.launch.serve import build_workload, run_fixed
    from repro_torch.serving import EngineConfig, ServeEngine

    wl = build_workload(model.cfg, 5, prompt_len, 4, gen_spread=2,
                        prefix_len=8)
    fixed = run_fixed(model, params, [r.clone() for r in wl], batch=5)
    max_len = prompt_len + max(r.max_new_tokens for r in wl)
    tw = -(-max_len // 4)
    ecfg = EngineConfig(lanes=2, page_size=4, num_pages=2 * tw + 1 + 4,
                        max_len=max_len, prefill_chunk=8, prefix_share=True)
    engine = ServeEngine(model, params, ecfg)
    cont, _ = engine.run(wl)
    return fixed, cont, sorted(engine.prefill_signatures)


def same_tokens(a, b) -> bool:
    import numpy as np

    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def serve_smoke(cases=tuple(SERVE_CASES)):
    """(a): on the card, the continuous engine's tokens equal the fixed
    driver's for every request, and both equal the port's CPU run on the
    same parameters (drawn on the CPU and moved); serving launches no
    kernel of K1, K2 or K3."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM

    launches = dict(ops.LAUNCHES)
    for arch, prompt_len in cases:
        model = LM(get_config(arch, smoke=True))
        cpu = model.init(prng.PRNGKey(0), "cpu")
        card = tree_map(lambda t: t.cuda(), cpu)
        fixed, cont, sigs = serve_smoke_run(arch, prompt_len, card, model)
        fixed_cpu, cont_cpu, _ = serve_smoke_run(arch, prompt_len, cpu, model)
        check(same_tokens(cont, fixed),
              f"serve[{arch}, prompt {prompt_len}]: continuous != fixed on "
              f"the card")
        check(same_tokens(fixed, fixed_cpu) and same_tokens(cont, cont_cpu),
              f"serve[{arch}, prompt {prompt_len}]: the card's tokens != the "
              f"CPU's")
        n_tok = sum(len(v) for v in cont.values())
        print(f"serve[{arch}, prompt {prompt_len}]: {len(cont)} requests, "
              f"{n_tok} tokens: continuous == fixed on the card == the CPU "
              f"run; prefill signatures (Cb, Bb, tw) {sigs}")
    check(dict(ops.LAUNCHES) == launches,
          f"serving launched a kernel: {launches} -> {dict(ops.LAUNCHES)}")


def run_serve(argv):
    """``repro_torch.launch.serve.main`` in this process; returns (results,
    summary, engine, seconds)."""
    import torch

    from repro_torch.launch import serve

    t0 = time.perf_counter()
    results, summary, engine = serve.main(argv)
    torch.cuda.synchronize()
    return results, summary, engine, time.perf_counter() - t0


def fixed_top2(model, params, workload, batch=SERVE_BATCH, gen=SERVE_GEN):
    """The fixed-batch driver again, recording the two largest logits of
    every row at every step: {request_id: (gen, 2) float32}, and its
    tokens."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import run_fixed
    from repro_torch.serving import sample_greedy

    rec = []

    def top2(logits):
        rec.append(torch.topk(logits[:, -1].float(), 2, dim=-1).values.cpu())

    def prefill(params, feed, cache):
        logits, cache = model.prefill(params, feed, cache)
        top2(logits)
        return logits, cache

    def step(params, tok, cache, pos):
        logits, cache = model.decode_step(params, tok, cache, pos)
        top2(logits)
        return sample_greedy(logits), cache

    tokens = run_fixed(model, params, workload, batch, fns=(prefill, step))
    out = {}
    for i, r in enumerate(workload):
        g, lane = divmod(i, batch)
        out[r.request_id] = np.stack(
            [rec[g * gen + j][lane].numpy() for j in range(gen)])
    return out, tokens


def near_ties(cont, fixed, top2, gen: int, label: str):
    """Check that each continuous stream equals the fixed driver's up to a
    first difference, if any, and that there the fixed driver's two largest
    logits lie within 2 bfloat16 ULPs of the largest's magnitude. Prints
    each first difference; returns (streams that part, the smallest top-two
    gap of each request in bf16 ULPs)."""
    import torch

    check(set(fixed) == set(cont), f"{label}: fixed and continuous requests")
    gaps = []
    for rid in sorted(top2):
        hi, lo = top2[rid][:, 0], top2[rid][:, 1]
        ulp = bf16_ulp(torch.from_numpy(hi).abs()).numpy()
        gaps.append(float(((hi - lo) / ulp).min()))
    parted = 0
    for rid in sorted(cont):
        a, b = cont[rid], fixed[rid]
        diff = [j for j in range(gen) if a[j] != b[j]]
        if not diff:
            continue
        j = diff[0]
        hi, lo = (float(v) for v in top2[rid][j])
        ulp = float(bf16_ulp(torch.tensor(abs(hi))))
        print(f"{label}: {rid} first differs at token {j}: fixed top logits "
              f"{hi!r} / {lo!r}, gap {hi - lo:.6g} = {(hi - lo) / ulp:g} "
              f"bf16 ULP")
        check(hi - lo <= 2 * ulp, f"{label}: {rid} differs at token {j} "
                                  f"without a near-tie")
        parted += 1
    return parted, gaps


def serve_full(root: str, card: str):
    """(b): train, checkpoint, restore, age, compensate and serve
    Qwen2-0.5B at full width and depth. Gates: 2 K1 launches per analog
    path per training step and none while serving; the manifest validates,
    its lifetime block names the checkpoint's t0 signatures and carries the
    drift scales; every request has 32 tokens; each request's stream
    equals the fixed driver's up to its first difference, if it has one,
    and there the fixed driver's two largest logits lie within 2 bfloat16
    ULPs of the largest's magnitude (a near-tie that another summation
    order may break either way)."""
    import gc
    import json as _json

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
    from repro_torch.core.trainer import AnalogTrainer, TrainerConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_workload, parse_age
    from repro_torch.launch.train import make_plan
    from repro_torch.models.lm import LM
    from repro_torch.serving import load_effective_params, schema

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist, _ = run_cli(LM_ARGV + [
        "--steps", str(SERVE_STEPS), "--ckpt-dir", root, "--ckpt-every",
        str(SERVE_STEPS), "--device", "cuda"])
    train_s = time.perf_counter() - t0
    n_paths = sum(len(ps) for _, ps in state["tiles"].index)
    check(ops.LAUNCHES["analog_update"] == 2 * n_paths * SERVE_STEPS,
          f"serve: training launched K1 {ops.LAUNCHES['analog_update']} times")
    trained = hash_launches("serve", True)
    timed = os.path.join(root, "timed_save")
    t0 = time.perf_counter()
    ckpt.save(state, timed, SERVE_STEPS)
    save_s = time.perf_counter() - t0
    shutil.rmtree(timed, ignore_errors=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    model = LM(get_config("qwen2-0.5b"))
    trainer = AnalogTrainer(
        model.loss,
        TrainerConfig(digital=DigitalOptConfig(kind="sgdm"),
                      schedule=ScheduleConfig(kind="constant", base_lr=0.0)),
        plan=make_plan("erider", False))
    template = trainer.abstract_state(model.abstract_params("cuda"), "cuda")
    t0 = time.perf_counter()
    restored = ckpt.restore(template, root)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del restored, template
    gc.collect()
    torch.cuda.empty_cache()

    launches = dict(ops.LAUNCHES)
    out = os.path.join(root, "out")
    os.makedirs(out, exist_ok=True)
    man_path = os.path.join(out, "manifest.json")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cont, summary, engine, cont_s = run_serve(SERVE_ARGV + [
        "--ckpt-dir", root, "--log-json", os.path.join(out, "log.jsonl"),
        "--manifest", man_path, "--dump-tokens",
        os.path.join(out, "continuous.json")])
    peak = torch.cuda.max_memory_allocated()
    sigs = sorted(engine.prefill_signatures)
    ecfg = engine.ecfg
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    fixed, fsummary, _, fixed_s = run_serve(SERVE_ARGV + [
        "--ckpt-dir", root, "--engine", "fixed", "--batch", str(SERVE_BATCH),
        "--dump-tokens", os.path.join(out, "fixed.json")])
    # serving launches no K1/K2/K3 and draws no device; the load's aging
    # draws its drift and read noise (``lifetime/drift.py``) through the
    # hash_normal kernel
    drawn = ops.LAUNCHES["hash_normal"] - launches["hash_normal"]
    check(all(ops.LAUNCHES[k] == launches[k] for k in launches
              if k != "hash_normal"), "serve: serving launched a kernel")
    check(drawn > 0, "serve: the aged load drew no normal on the card")
    print(f"serve: no K1/K2/K3 or hash_device launch; the two aged loads "
          f"drew {drawn} hash_normal launches")

    with open(man_path) as f:
        manifest = _json.load(f)
    schema.validate_manifest(manifest)
    with open(os.path.join(out, "log.jsonl")) as f:
        for line in f:
            schema.validate_log_line(_json.loads(line))
    life = manifest.get("lifetime", {})
    check(life.get("t0_signature") == "checkpoint",
          f"serve: t0_signature {life.get('t0_signature')}")
    check(bool(life.get("drift_scale")), "serve: no drift_scale")
    check(life.get("age_s") == parse_age("1yr") and life.get("gdc") is True,
          "serve: lifetime block")
    check(len(cont) == 16 and all(len(v) == SERVE_GEN for v in cont.values()),
          "serve: a request without 32 tokens")
    # the fixed driver once more, in process, recording its two top logits
    # at every step: it must reproduce the CLI's tokens, and every first
    # difference must sit at a near-tie
    t0 = time.perf_counter()
    params, _ = load_effective_params(
        model, root, "erider", False, age_s=parse_age("1yr"), gdc=True,
        with_report=True, device="cuda")
    workload = build_workload(model.cfg, 16, 128, SERVE_GEN, data_vocab=8192)
    top2, again = fixed_top2(model, params, workload)
    del params
    check(same_tokens(again, fixed), "serve: the fixed driver is not "
                                     "reproducible")
    ties, gaps = near_ties(cont, fixed, top2, SERVE_GEN, "serve")
    print(f"serve: the fixed driver's top-two logit gap, smallest over each "
          f"request's 32 steps: median {statistics.median(gaps):g}, least "
          f"{min(gaps):g} bf16 ULP (a gap of <= 2 is a near-tie; near-tie "
          f"check {time.perf_counter() - t0:.1f} s)")
    lat = manifest["latency_s"]
    steps = manifest["throughput"]["steps"]
    print(f"serve: qwen2-0.5b full width and depth, trained {SERVE_STEPS} "
          f"steps ({train_s:.1f} s with its checkpoint), aged 1 yr, GDC "
          f"({len(life['drift_scale'])} scan classes, t0 signatures from the "
          f"checkpoint); continuous: {ecfg.lanes} lanes, page "
          f"{ecfg.page_size}, chunk {manifest['engine']['prefill_chunk']}, "
          f"{ecfg.num_pages} pages; requests equal to the fixed driver's: "
          f"{16 - ties} of 16, the rest at near-ties: {ties}")
    print(f"serve: {summary['tokens_per_s']:.2f} tokens/s continuous "
          f"({summary['generated_tokens']} tokens in {summary['wall_s']:.3f} "
          f"s, {steps} decode steps), {fsummary['tokens_per_s']:.2f} tokens/s "
          f"fixed (batch {SERVE_BATCH}), on {card}")
    print(f"serve: TTFT p50 {lat['ttft']['p50'] * 1e3:.2f} ms, p99 "
          f"{lat['ttft']['p99'] * 1e3:.2f} ms; TPOT p50 "
          f"{lat['tpot']['p50'] * 1e3:.2f} ms, p99 {lat['tpot']['p99'] * 1e3:.2f}"
          f" ms; decode step median {lat['gap']['p50'] * 1e3:.2f} ms (the "
          f"pooled inter-token gap), on {card}")
    print(f"serve: peak allocated {peak / 2 ** 30:.3f} GiB during the "
          f"continuous CLI run ({before / 2 ** 30:.3f} GiB before; restore, "
          f"age, GDC and serving), on {card}")
    print(f"serve: save {save_s:.2f} s (sync, no signatures), restore "
          f"{restore_s:.2f} s (abstract template, on the card), CLI runs "
          f"{cont_s:.1f} s continuous / {fixed_s:.1f} s fixed (restore, "
          f"lifetime, workload and serving), on {card}")
    print(f"serve: prefill signatures (Cb, Bb, tw) {sigs}")
    return dict(tokens_per_s=summary["tokens_per_s"],
                step_ms=lat["gap"]["p50"] * 1e3, peak_bytes=peak,
                train_launches=2 * n_paths * SERVE_STEPS,
                device_launches=trained["device"], normal_launches=drawn)


def phase_serve(card: str):
    t0 = time.time()
    serve_smoke()
    root = os.path.join(ROOT, "build", "serve_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        full = serve_full(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"serve: phase 12 took {time.time() - t0:.1f} s")
    return full


# Phase 13: serving the other families. (a) The smoke configs of
# minicpm3-4b and deepseek-v2-236b (MLA latent rows), recurrentgemma-9b
# (RG-LRU state beside sliding-window attention) and mamba2-2.7b (SSD state)
# on phase 12a's workload, and seamless-m4t-large-v2 through the fixed driver
# with FeedBuilder's frames. (b) MiniCPM3-4B at full width and depth
# (src/repro/configs/minicpm3_4b.py: 62 MLA layers, d 2560, kv_lora 256,
# vocab 73448, bf16), its weights from LM.init on the card: 16 requests,
# prompt 128, gen 32, the dense family's defaults (8 lanes, page 16, chunk
# 64: the chunk continuation of mla_chunk_lanes), then the fixed driver,
# batch 8. (c) Mamba2-2.7B at full width and depth
# (src/repro/configs/mamba2_2_7b.py: 64 SSD layers, 80 heads x 64 x N 128,
# bf16): 32 requests, prompt 512, gen 32, the ssm family's 16 lanes and page
# 32, chunk 256 (two chunks aligned to ssm_chunk: the state carried across
# the boundary), then the fixed driver, batch 16. Prompts over the first
# 8192 ids.
ZOO_SERVE_CASES = [(a, 10) for a in ("minicpm3-4b", "deepseek-v2-236b",
                                     "recurrentgemma-9b", "mamba2-2.7b")]
ZOO_FULL = {
    "minicpm3-4b": dict(requests=16, prompt=128, gen=32, batch=8, chunk=64),
    "mamba2-2.7b": dict(requests=32, prompt=512, gen=32, batch=16, chunk=256),
}


def serve_encdec_smoke():
    """(a) for seamless-m4t-large-v2: the fixed driver (the encoder over
    FeedBuilder's frames, the cross K/V cached) on the card gives the CPU's
    tokens on phase 12a's workload."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import tree_map
    from repro_torch.launch.serve import build_workload, run_fixed
    from repro_torch.models.lm import LM

    model = LM(get_config("seamless-m4t-large-v2", smoke=True))
    cpu = model.init(prng.PRNGKey(0), "cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    wl = build_workload(model.cfg, 5, 10, 4, gen_spread=2, prefix_len=8)
    got = run_fixed(model, card, [r.clone() for r in wl], batch=5)
    want = run_fixed(model, cpu, [r.clone() for r in wl], batch=5)
    check(same_tokens(got, want), "serve_zoo[seamless-m4t-large-v2]: the "
                                  "card's tokens != the CPU's")
    print(f"serve_zoo[seamless-m4t-large-v2, prompt 10]: {len(got)} requests, "
          f"{sum(len(v) for v in got.values())} tokens through the fixed "
          f"driver with frames: the card == the CPU run")


def decode_step_profile(engine, steps: int = 3):
    """Kernel launches and device busy milliseconds per decode step of the
    engine (``torch.profiler``, its lane state after the run: every lane
    runs every layer whether live or not)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine._dev = torch.from_numpy(engine._ls.copy()).to("cuda")
    engine._step_call(engine._dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._step_call(engine._dev).cpu()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    return len(kernels) / steps, busy, wall


def serve_zoo_full(arch: str, card: str):
    """(b)/(c): serve ``arch`` at full width and depth through the serve CLI
    (continuous engine), then through its fixed driver, then the fixed
    driver once more in process recording its two top logits: no K1/K2/K3
    launch while serving; every request has its tokens; every stream equals
    the fixed driver's up to a first difference at a near-tie."""
    import gc

    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_workload
    from repro_torch.models.lm import LM

    c = ZOO_FULL[arch]
    argv = ["--arch", arch, "--requests", str(c["requests"]), "--prompt-len",
            str(c["prompt"]), "--gen", str(c["gen"]), "--data-vocab", "8192",
            "--prefill-chunk", str(c["chunk"]), "--device", "cuda"]
    label = f"serve_zoo[{arch}]"
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    cont, summary, engine, cont_s = run_serve(argv)
    peak = torch.cuda.max_memory_allocated()
    ecfg, sigs, chunk = engine.ecfg, sorted(engine.prefill_signatures), engine._chunk
    lat = engine.telemetry.latency_summary()
    steps = engine.telemetry.steps
    launches, busy, traced = decode_step_profile(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    fixed, fsummary, _, fixed_s = run_serve(argv + [
        "--engine", "fixed", "--batch", str(c["batch"])])
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"{label}: serving launched a kernel: {dict(ops.LAUNCHES)}")
    check(len(cont) == c["requests"]
          and all(len(v) == c["gen"] for v in cont.values()),
          f"{label}: a request without {c['gen']} tokens")
    check(chunk == c["chunk"], f"{label}: prefill chunk {chunk}")

    t0 = time.perf_counter()
    model = LM(get_config(arch))
    with torch.no_grad():
        params = model.init(prng.PRNGKey(0), "cuda")
    workload = build_workload(model.cfg, c["requests"], c["prompt"], c["gen"],
                              data_vocab=8192)
    top2, again = fixed_top2(model, params, workload, c["batch"], c["gen"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    check(same_tokens(again, fixed), f"{label}: the fixed driver is not "
                                     f"reproducible")
    parted, gaps = near_ties(cont, fixed, top2, c["gen"], label)
    n = c["requests"]
    dtype = str(model.cfg.dtype).replace("torch.", "")
    print(f"{label}: full width and depth ({model.cfg.n_layers} layers, d "
          f"{model.cfg.d_model}, {dtype}, weights from LM.init on the card); "
          f"continuous: {ecfg.lanes} lanes, page {ecfg.page_size}, chunk "
          f"{chunk}, {ecfg.num_pages} pages; streams equal to the fixed "
          f"driver's: {n - parted} of {n}, parting at a near-tie: {parted}; "
          f"the fixed driver's top-two logit gap, smallest over each "
          f"request's {c['gen']} steps: median {statistics.median(gaps):g}, "
          f"least {min(gaps):g} bf16 ULP (near-tie check "
          f"{time.perf_counter() - t0:.1f} s)")
    print(f"{label}: {summary['tokens_per_s']:.2f} tokens/s continuous "
          f"({summary['generated_tokens']} tokens in {summary['wall_s']:.3f} "
          f"s, {steps} decode steps), {fsummary['tokens_per_s']:.2f} tokens/s "
          f"fixed (batch {c['batch']}), on {card}")
    print(f"{label}: TTFT p50 {lat['ttft']['p50'] * 1e3:.2f} ms, p99 "
          f"{lat['ttft']['p99'] * 1e3:.2f} ms; TPOT p50 "
          f"{lat['tpot']['p50'] * 1e3:.2f} ms, p99 {lat['tpot']['p99'] * 1e3:.2f}"
          f" ms; decode step median {lat['gap']['p50'] * 1e3:.2f} ms (the "
          f"pooled inter-token gap), on {card}")
    print(f"{label}: a decode step issues {launches:.0f} kernel launches "
          f"({launches / model.cfg.n_layers:.1f} a layer), {busy:.3f} ms of "
          f"device time ({traced:.2f} ms traced wall), on {card}")
    print(f"{label}: peak allocated {peak / 2 ** 30:.3f} GiB during the "
          f"continuous CLI run (weights, cache and serving), on {card}")
    print(f"{label}: CLI runs {cont_s:.1f} s continuous / {fixed_s:.1f} s "
          f"fixed (init, workload and serving); prefill signatures (Cb, Bb, "
          f"tw) {sigs}")
    return dict(tokens_per_s=summary["tokens_per_s"],
                step_ms=lat["gap"]["p50"] * 1e3, peak_bytes=peak,
                launches=launches, parted=parted)


def phase_serve_zoo(card: str):
    from repro_torch.kernels import ops

    t0 = time.time()
    ops.reset_launch_counts()
    serve_smoke(ZOO_SERVE_CASES)
    serve_encdec_smoke()
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"serve_zoo: serving launched a kernel: {dict(ops.LAUNCHES)}")
    full = {arch: serve_zoo_full(arch, card) for arch in ZOO_FULL}
    print(f"serve_zoo: phase 13 took {time.time() - t0:.1f} s")
    return full


# Phase 14: the paper's own workloads through the port's benchmark harness
# (``repro_torch.benchmarks.common``, the JAX package's benchmarks/common.py):
# LeNet-5 (conv5x5(16) -> pool -> conv5x5(32) -> pool -> fc512 -> fc128 ->
# 10, src/repro/models/convnets.py) at full width, and the FCN, batch 64 of
# the procedural MNIST stand-in (seed 11).
PAPER_CHECK_STEPS = 3
# examples/analog_mnist.py and tests/test_system.py: ~4 states, SP
# reference N(0.4, 0.4^2), 2 epochs of 4096 images, seed 1
TABLES_DEVICE = dict(dw_min=0.4622, sigma_pm=0.7125, sigma_c2c=0.2174,
                     ref_mean=0.4, ref_std=0.4)
TABLES_ALGOS = ("ttv2", "agad", "erider")
SYNC_STEPS = 20


def paper_snapshot(state, metrics):
    """Loss, every float tile leaf per class and every digital leaf, on the
    host."""
    from repro_torch.core.paths import flatten_with_path

    tiles = {f"{c}/{k}": st[k].detach().cpu().clone()
             for c, st in state["tiles"].classes.items()
             for k in ("W", "P", "Qd", "Qt", "H") if st.get(k) is not None}
    return dict(loss=float(metrics["loss"]), tiles=tiles,
                digital={p: v.detach().cpu().clone()
                         for p, v in flatten_with_path(state["params"])})


def lenet_steps(backend: str, batches, device):
    """LeNet-5 under ``train_image_model``'s E-RIDER trainer on
    ``device_pair()``'s devices (``update_backend=backend``), its state drawn
    on the CPU from seeds 0/1 and carried to ``device``: the snapshots after
    each of ``batches`` and the K1 launches they made."""
    from repro_torch import prng
    from repro_torch.benchmarks.common import device_pair, image_trainer
    from repro_torch.kernels import ops
    from repro_torch.models import convnets

    trainer, ccfg, _ = image_trainer("erider", "lenet5", *device_pair(),
                                     hp_overrides={"update_backend": backend})
    state = trainer.init(prng.PRNGKey(1),
                         convnets.init_convnet(prng.PRNGKey(0), ccfg, "cpu"))
    n_tiles = sum(len(ps) for _, ps in state["tiles"].index)
    state = to_device(state, device)
    ops.reset_launch_counts()
    snaps = []
    for b in batches:
        state, m = trainer.train_step(state, {k: v.to(device)
                                              for k, v in b.items()})
        snaps.append(paper_snapshot(state, m))
    return snaps, ops.LAUNCHES["analog_update"], n_tiles


def lenet_against_cpu(backend: str) -> int:
    """(a) LeNet-5's first 3 steps on the card against the port's CPU run,
    to phase 11a's standard: loss within rtol 1e-5; every float tile leaf
    (W, P, Qd, Qt, H) within 1e-5 on all but at most 0.1 % of its elements,
    each such element one that a flipped stochastic-rounding pulse in P
    explains (P off there by at least a tenth of dw_min); digital leaves
    within rtol 1e-5; 2 K1 launches per tile per step; a second card run
    bit-equal to the first (deterministic cuDNN). Returns the launches of
    the first card run."""
    import numpy as np
    import torch

    from repro_torch.data import ImageDataset

    data = ImageDataset(n_train=64 * PAPER_CHECK_STEPS, n_test=64, seed=11)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in data.epoch(0, 64)]
    card, launches, n_tiles = lenet_steps(backend, batches, "cuda")
    again, _, _ = lenet_steps(backend, batches, "cuda")
    cpu, _, _ = lenet_steps(backend, batches, "cpu")
    label = f"paper[lenet5 {backend}]"
    for a, b in zip(card, again):
        check(a["loss"] == b["loss"], f"{label}: two card runs differ in loss")
        for part in ("tiles", "digital"):
            for k, v in a[part].items():
                check(torch.equal(v, b[part][k]),
                      f"{label}: two card runs differ at {k}")
    rels = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
            for g, w in zip(card, cpu)]
    got, want = card[-1], cpu[-1]
    pulse = 0.01                      # dw_min of device_pair()
    off_n, n_el, worst = 0, 0, 0.0
    for k, w in want["tiles"].items():
        diff = (got["tiles"][k] - w).abs()
        off = diff > 1e-5
        check(off.float().mean().item() <= 1e-3, f"{label}: {k} off the CPU run")
        p_diff = (got["tiles"][k.rsplit("/", 1)[0] + "/P"]
                  - want["tiles"][k.rsplit("/", 1)[0] + "/P"]).abs()
        check(bool((p_diff[off] >= 0.1 * pulse).all()),
              f"{label}: {k} drifts off the CPU run where no pulse flipped")
        off_n += int(off.sum())
        n_el += off.numel()
        worst = max(worst, diff.max().item())
    for k, w in want["digital"].items():
        np.testing.assert_allclose(got["digital"][k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=f"{label} {k}")
    print(f"{label}: {n_tiles} tiles, {launches} K1 launches in "
          f"{PAPER_CHECK_STEPS} steps; loss card vs cpu rel "
          f"{', '.join(f'{r:.2e}' for r in rels)} (step 0 {card[0]['loss']:.6g});"
          f" tile elements off by > 1e-5: {off_n} of {n_el} (largest "
          f"{worst:.3g}); two card runs bit-equal")
    check(all(math.isfinite(s["loss"]) for s in card), f"{label}: non-finite loss")
    check(max(rels) <= 1e-5, f"{label}: loss off the CPU run")
    check(launches == 2 * n_tiles * PAPER_CHECK_STEPS,
          f"{label}: launches {launches} != {2 * n_tiles * PAPER_CHECK_STEPS}")
    return launches


def host_sync_cost(card: str):
    """What ``train_image_model``'s per-step host reads (loss, pulses,
    sp_err, as the reference reads them) cost on the card: LeNet-5 E-RIDER
    steps with the reads, then as many with one synchronization at the end."""
    import torch

    from repro_torch import prng
    from repro_torch.benchmarks.common import device_pair, image_trainer
    from repro_torch.data import ImageDataset
    from repro_torch.models import convnets

    trainer, ccfg, _ = image_trainer("erider", "lenet5",
                                     *device_pair(**TABLES_DEVICE))
    state = trainer.init(prng.PRNGKey(2),
                         convnets.init_convnet(prng.PRNGKey(1), ccfg, "cuda"))
    data = ImageDataset(n_train=64 * (2 * SYNC_STEPS + 3), n_test=64, seed=11)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for b in data.epoch(0, 64)]
    for b in batches[:3]:
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[3:3 + SYNC_STEPS]:
        state, m = trainer.train_step(state, b)
        float(m["loss"]), float(m["tile/pulses"]), float(m["tile/sp_err"])
    synced = (time.perf_counter() - t0) * 1e3 / SYNC_STEPS
    t0 = time.perf_counter()
    for b in batches[3 + SYNC_STEPS:]:
        state, m = trainer.train_step(state, b)
    torch.cuda.synchronize()
    free = (time.perf_counter() - t0) * 1e3 / SYNC_STEPS
    print(f"paper: LeNet-5 E-RIDER step {synced:.2f} ms with the 3 host reads a "
          f"step, {free:.2f} ms with one sync per {SYNC_STEPS} steps "
          f"(reads {synced - free:.2f} ms a step) on {card}")
    return dict(synced_ms=synced, free_ms=free)


def paper_run(label: str, **kw):
    """One ``train_image_model`` run on the card with its K1 launches."""
    from repro_torch.benchmarks.common import train_image_model
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = train_image_model(device="cuda", **kw)
    launches = ops.LAUNCHES["analog_update"]
    check(all(math.isfinite(x) for x in res.losses), f"{label}: non-finite loss")
    check(launches > 0, f"{label}: no K1 launch")
    return res, launches


def phase_paper(card: str):
    """(a) LeNet-5 card against CPU under both backends; (b) the Tables 1-2
    comparison of TT-v2, AGAD and E-RIDER on the FCN and LeNet-5 at
    examples/analog_mnist.py's setting: E-RIDER's test accuracy above
    TT-v2's on each model; (c) tests/test_system.py's FCN learning and
    SP-tracking claim.
    Returns the K1 launches of its runs on the card and the numbers."""
    import torch

    from repro_torch.benchmarks.common import cuda_numerics, device_pair
    from repro_torch.data import ImageDataset

    cuda_numerics()
    t0 = time.time()
    launches = sum(lenet_against_cpu(b) for b in ("vmap", "fused"))
    print(f"paper: (a) took {time.time() - t0:.1f} s")
    sync = host_sync_cost(card)

    t1 = time.time()
    dev_p, dev_w = device_pair(**TABLES_DEVICE)
    data = ImageDataset(n_train=4096, n_test=1024, seed=11)
    table = {}
    for kind in ("fcn", "lenet5"):
        for algo in TABLES_ALGOS:
            label = f"paper[{kind} {algo}]"
            res, n = paper_run(label, algorithm=algo, model_kind=kind,
                               dev_p=dev_p, dev_w=dev_w, epochs=2, data=data,
                               seed=1)
            launches += n
            steps = len(res.losses)
            sp = "none" if res.sp_err is None else f"{res.sp_err:.4f}"
            print(f"{label}: test_acc {res.test_acc:.4f} sp_err {sp} pulses "
                  f"{res.pulses:.4e} final loss {res.losses[-1]:.4f} wall "
                  f"{res.wall_s:.2f} s ({steps} steps, {n} K1 launches, "
                  f"{res.wall_s * 1e3 / steps:.2f} ms/step) on {card}")
            table[(kind, algo)] = res
        er, tt = table[(kind, "erider")], table[(kind, "ttv2")]
        print(f"paper[{kind}]: E-RIDER test_acc {er.test_acc:.4f} > TT-v2 "
              f"{tt.test_acc:.4f}: {er.test_acc > tt.test_acc}")
        check(er.test_acc > tt.test_acc,
              f"paper: E-RIDER does not beat TT-v2 on {kind}")
    print(f"paper: (b) took {time.time() - t1:.1f} s")

    # (c) tests/test_system.py::test_analog_fcn_learns_and_tracks_sp
    dev_p, dev_w = device_pair(dw_min=0.02, ref_mean=0.3, ref_std=0.2)
    res, n = paper_run("paper[learns]", algorithm="erider", dev_p=dev_p,
                       dev_w=dev_w, epochs=1, seed=0)
    launches += n
    print(f"paper[learns]: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"test_acc {res.test_acc:.4f} (> 0.3), sp_err {res.sp_err:.4f} (< "
          f"{0.3 ** 2 + 0.2 ** 2:.2f}), pulses {res.pulses:.4e}, {n} K1 "
          f"launches, wall {res.wall_s:.2f} s on {card}")
    check(res.losses[0] > res.losses[-1], "paper[learns]: loss did not fall")
    check(res.test_acc > 0.3, f"paper[learns]: test_acc {res.test_acc}")
    check(res.sp_err is not None and res.sp_err < 0.3 ** 2 + 0.2 ** 2,
          f"paper[learns]: sp_err {res.sp_err}")
    torch.cuda.synchronize()
    print(f"paper: phase 14 took {time.time() - t0:.1f} s")
    return dict(launches=launches, sync=sync,
                table={f"{k}/{a}": r.test_acc for (k, a), r in table.items()})


# ---------------------------------------------------------------------------
# Phase 15: distribution. Ranks are processes sharing the card: a gloo
# process group (NCCL refuses two ranks on one device), every collective
# of a CUDA tensor staged through host memory (``distributed.runtime``).
# They start with the spawn method after phase 2 built the kernels (a rank
# only loads build/torch_ext/) and meet over a file under build/.
# (a) the int8 compressed all-reduce of a (2, 2^24) float32 gradient, card
#     == the same ranks on the CPU, within the reference's bounds;
# (b) Qwen2-0.5B's full-width tile bank of the CLI's plan (bf16, hash
#     noise, 24 layers) as (c)'s run A leaves it at step 2: one begin_step
#     and one update with seeded gradients on the two data ranks, gathered,
#     bit-equal to the one-process update on the card; K1 launches, rows
#     and device time per rank;
# (c) the CLI at phase 10a's full width and depth with --data-parallel 2:
#     steps 0-1 (checkpoint at 2), then a restart on the mesh for steps
#     2-3; the loss finite and falling, step 0 within 1e-3 of phase 10a's
#     one-rank step 0; ms/step, peak memory and tile bytes per rank, the
#     gradient all-reduce's milliseconds a step; the step-2 checkpoint
#     restored in one process with no mesh, bit-equal to the ranks'
#     gathered state, then one more step;
# (d) the reference's 2x2 sharded bank (tests/test_distributed.py) on four
#     ranks: its specs, tile bytes per rank <= total / 2 + 1024, two steps
#     bit-equal to one process.
DIST_COMPRESS = (2, 1 << 24)
DIST_STEPS = 4


def dist_spawn(world: int, target, *args, timeout: float = 900):
    """``target(*args)`` on ``world`` spawned ranks; returns their results
    in rank order. A rank that exits non-zero, or a run past ``timeout``
    seconds, fails the phase; every rank is joined or killed."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    init_file = os.path.join(ROOT, "build", f"dist_rdzv_{time.time_ns()}")
    q = ctx.Queue()
    procs = [ctx.Process(target=_dist_rank,
                         args=(target, r, world, init_file, q) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    try:
        while len(results) < world and time.time() < deadline:
            try:
                r, res = q.get(timeout=5)
                results[r] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 5))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init_file):
            os.remove(init_file)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world and len(results) == world,
          f"dist: ranks exited {codes} with {len(results)} of {world} results")
    return [results[r] for r in range(world)]


def _dist_rank(target, rank, world, init_file, q, *args):
    import torch

    from repro_torch.distributed import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.init(rank, world, init_file, device="cuda")
    try:
        q.put((rank, target(*args)))
    finally:
        runtime.shutdown()


def fingerprint(tree) -> dict:
    """{path: a position-weighted sum of each leaf's bits} (on its device)."""
    import torch

    from repro_torch.core.paths import flatten_with_path

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for p, t in flatten_with_path(tree):
        bits = t.contiguous().view(ints[t.element_size()]).reshape(-1).long()
        pos = torch.arange(bits.numel(), device=t.device) % 65521 + 1
        out[p] = int((bits * pos).sum())
    return out


def expected_k1(trainer, bank) -> int:
    """K1 launches of one update on this rank: two per tile it updates
    (its rows where the stack axis carries the data axes, else every tile
    of the stack), under update_backend="vmap"."""
    from repro_torch.distributed.sharding import mesh_axis_sizes

    _, dsize, _, _ = mesh_axis_sizes(trainer.mesh)
    n = 0
    for cname, gnames in bank.class_index:
        tiles = len(gnames) * len(dict(bank.index)[gnames[0]])
        rows = trainer.shardings["tiles"].classes[cname]["W"].spec[1]
        n += 2 * (tiles // dsize if rows is not None else tiles)
    return n


def dist_compress():
    """(a) on this rank's row of a seeded (2, 2^24) gradient."""
    import torch
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.distributed import compression, runtime

    g = prng.normal(prng.PRNGKey(22), DIST_COMPRESS, "cuda")
    x = g[runtime.rank()].contiguous()
    compression.compressed_psum_mean(x, dist.group.WORLD)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, err = compression.compressed_psum_mean(x, dist.group.WORLD)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    mean_c, err_c = compression.compressed_psum_mean(x.cpu(), dist.group.WORLD)
    scale = float(g.abs().max()) / 127
    return dict(equal=torch.equal(mean.cpu(), mean_c)
                and torch.equal(err.cpu(), err_c),
                gap=float((mean - g.mean(0)).abs().max()),
                err=float(err.abs().max()), scale=scale, ms=ms,
                route=runtime.route(x))


def _qwen_trainer(mesh):
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    model = LM(get_config("qwen2-0.5b"))
    return model, train.make_trainer(model, "erider", False, 8, mesh=mesh)


def dist_bank(tr, bank, whole):
    """(b): the CLI's tile bank at full width (``bank``, this rank's blocks
    after (c)'s run A; ``whole``, the same bank gathered), one begin_step
    and one update through the trainer's grouped phases, two ranks against
    one process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.core.tile import parse_group_name
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels import ops

    index = dict(bank.index)
    grads = {}
    for i, (cname, gnames) in enumerate(bank.class_index):
        shape = ((len(gnames), len(index[gnames[0]]))
                 + parse_group_name(gnames[0])[0])
        grads[cname] = 1e-3 * prng.normal(prng.PRNGKey(100 + i), shape, "cuda")
    kb, ku = prng.split(prng.PRNGKey(5), 2)
    lr = torch.tensor(0.1)
    rows = []
    launch = ops.analog_update

    def spy(w, *a, **k):
        rows.append(tuple(w.shape))
        return launch(w, *a, **k)

    runtime.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.analog_update = spy
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            new, _ = tr.update_tiles(tr.begin_tiles(bank, kb), grads, ku, lr)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        ops.analog_update = launch
    k1_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "analog_update" in e.name) / 1e3
    out = dict(launches=ops.LAUNCHES["analog_update"],
               expected=expected_k1(tr, bank), rows=rows, k1_ms=k1_ms,
               wall_ms=wall, peak=torch.cuda.max_memory_allocated(),
               local_bytes=tile_state_bytes({"tiles": bank}),
               whole_bytes=tile_state_bytes({"tiles": whole}),
               stats={k: dict(v) for k, v in runtime.STATS.items()})
    got = gather_tree(new, tr.shardings["tiles"])
    del new
    if runtime.rank() == 0:
        one = _qwen_trainer(None)[1]
        want, _ = one.update_tiles(one.begin_tiles(whole, kb), grads, ku, lr)
        pairs = list(zip(flatten_with_path(got), flatten_with_path(want)))
        check(all(p == q and torch.equal(x, y) for (p, x), (q, y) in pairs),
              "dist (b): two ranks differ from one process")
        out["equal"] = len(pairs)
    return out


def dist_pair(root: str):
    """(a), (c) and (b) on the same two ranks: (c)'s run A (steps 0-1,
    checkpoint at 2), (b) on its tile bank, then (c)'s run B (restores
    step 2 on the mesh, steps 2-3). Rank 0 then restores the step-2
    checkpoint in a trainer with no mesh, holds every leaf equal to the
    ranks' gathered step-2 state (kept on the host) and takes one step."""
    import torch

    from repro_torch.core.paths import flatten_with_path
    from repro_torch.distributed import runtime
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    a = dist_compress()
    argv = LM_ARGV + ["--data-parallel", "2", "--ckpt-dir", root,
                      "--device", "cuda"]
    runs = []
    for steps, every in ((2, 2), (DIST_STEPS, 100)):
        # run A saves step 2 twice (asynchronously, then at its end); run B
        # restores it and saves only at its end
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_stats()
        ops.reset_launch_counts()
        state, hist, out = run_cli(argv + ["--steps", str(steps),
                                           "--ckpt-every", str(every)])
        runs.append(dict(hist=hist, out=out,
                         launches=ops.LAUNCHES["analog_update"],
                         peak=torch.cuda.max_memory_allocated(),
                         stats={k: dict(v) for k, v in runtime.STATS.items()}))
        if steps == 2:
            tbytes = tile_state_bytes(state)
            model, tr = _qwen_trainer(make_host_mesh(2, 1))
            tr.abstract_state(model.abstract_params("cuda"), "cuda")
            whole = tr.gather_state(state)
            prints = fingerprint(whole)
            b = dist_bank(tr, state["tiles"], whole["tiles"])
            if runtime.rank() == 0:
                host = [(p, t.cpu()) for p, t in flatten_with_path(whole)]
            del whole
        del state
    restore = dist_restore(root, host) if runtime.rank() == 0 else None
    stats = {}
    for run in runs:
        for k, v in run["stats"].items():
            acc = stats.setdefault(k, {"calls": 0, "bytes": 0, "seconds": 0.0})
            for f in acc:
                acc[f] += v[f]
    c = dict(hist=runs[0]["hist"] + runs[1]["hist"], tile_bytes=tbytes,
             prints=prints, stats=stats,
             restored=("restored checkpoint at step 2" in runs[1]["out"]
                       or runtime.rank() != 0),
             peak=max(r["peak"] for r in runs),
             launches=sum(r["launches"] for r in runs), restore=restore)
    return dict(a=a, b=b, c=c)


def dist_restore(root: str, host):
    """(c)'s step-2 checkpoint in a trainer with no mesh on the card:
    the number of leaves equal (``torch.equal``) to ``host``, the ranks'
    gathered step-2 state as (path, host tensor) pairs, and the loss of
    one more step."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.core.trainer import HOST_LEAVES
    from repro_torch.data import BigramLM

    torch.cuda.empty_cache()
    model, one = _qwen_trainer(None)
    template = one.abstract_state(model.abstract_params("cuda"), "cuda")
    st = ckpt.restore(template, root, step=2, host_leaves=HOST_LEAVES)
    want, got = host, flatten_with_path(st)
    equal = (len(got) == len(want) and all(
        p == q and torch.equal(x.cpu(), y)
        for (p, x), (q, y) in zip(got, want)))
    data = BigramLM(vocab=8192, seed=7)
    batch = {k: torch.as_tensor(v.copy()).to("cuda")
             for k, v in data.batch(2, 8, 128).items()}
    st, m = one.train_step(st, batch)
    return dict(equal=len(want) if equal else 0, loss=float(m["loss"]))


def dist_ref_bank():
    """(d): tests/test_distributed.py's 2x2 case on this rank."""
    import torch

    from repro_torch import prng
    from repro_torch.core.device import DeviceConfig
    from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
    from repro_torch.core.paths import leaves
    from repro_torch.core.plan import AnalogPlan, TilePolicy
    from repro_torch.core.tile import TileConfig
    from repro_torch.core.trainer import AnalogTrainer, TrainerConfig
    from repro_torch.distributed import runtime
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    dev = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
    cfg = TrainerConfig(
        tile=TileConfig(algorithm="erider", device_p=dev, device_w=dev),
        digital=DigitalOptConfig(kind="sgd"),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1))
    plan = AnalogPlan.of(("**", TilePolicy(cfg.tile, name="erider")))

    def loss(params, batch, rng):
        return sum(torch.sum(v ** 2) for _, v in sorted(params.items())), {}

    def params():
        p = {}
        for i in range(2):
            p[f"l{i}/attn/wq"] = 0.1 * torch.ones((8, 8), device="cuda")
            p[f"l{i}/attn/wo"] = 0.1 * torch.ones((8, 8), device="cuda")
        return p

    tr = AnalogTrainer(loss, cfg, mesh=make_host_mesh(2, 2), plan=plan)
    state = tr.init(prng.PRNGKey(0), params())
    cname = "g8x8_float32_Mn+g8x8_float32_nM"
    sh = tr.shardings["tiles"].classes[cname]
    whole0 = tr.gather_state(state)
    total = sum(t.numel() * t.element_size() for t in leaves(whole0["tiles"]))
    per_dev = sum(t.numel() * t.element_size() for t in leaves(state["tiles"]))
    ops.reset_launch_counts()
    for _ in range(2):
        state, m = tr.train_step(state, torch.zeros(()))
    launches = ops.LAUNCHES["analog_update"]
    got = tr.gather_state(state)
    out = dict(names=sorted(g for g, _ in state["tiles"].index),
               classes=[c for c, _ in state["tiles"].class_index],
               w_spec=tuple(sh["W"].spec), t_spec=tuple(sh["t"].spec),
               total=total, per_dev=per_dev, loss=float(m["loss"]),
               launches=launches)
    if runtime.rank() == 0:
        one = AnalogTrainer(loss, cfg, plan=plan)
        s1 = whole0
        for _ in range(2):
            s1, _ = one.train_step(s1, torch.zeros(()))
        out["equal"] = leaves_equal(got, s1, "dist 2x2: four ranks")
    return out


def phase_dist(card: str, lm_losses):
    """Phase 15 (see above); ``lm_losses``: phase 10a's one-rank losses.
    Returns the K1 launches of its sharded runs."""
    import torch

    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.join(ROOT, "build", "dist_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        pair = dist_spawn(2, dist_pair, root)
        a = [r["a"] for r in pair]
        for r in a:
            check(r["equal"], "dist (a): card != CPU")
            check(r["gap"] < 3 * r["scale"] and r["err"] <= 1.01 * r["scale"],
                  f"dist (a): bounds {r}")
            check(r["route"] == "host", f"dist (a): route {r['route']}")
        print(f"dist (a): compressed all-reduce of {DIST_COMPRESS} float32 on "
              f"2 ranks: card == CPU bit for bit, max |mean - true mean| "
              f"{a[0]['gap']:.3e} < 3 * scale {a[0]['scale']:.3e}, max |err| "
              f"{a[0]['err']:.3e}; {a[0]['ms']:.2f} / {a[1]['ms']:.2f} ms per "
              f"call (host clock, staged through host memory) on {card}")
        b = [r["b"] for r in pair]
        check(b[0]["equal"] > 0, "dist (b): no leaf compared")
        for r, rb in enumerate(b):
            check(rb["launches"] == rb["expected"] == len(rb["rows"]),
                  f"dist (b) rank {r}: {rb['launches']} K1 launches, "
                  f"expected {rb['expected']}")
            print(f"dist (b) rank {r}: {rb['launches']} K1 launches on "
                  f"{sorted(set(rb['rows']))}; K1 device time "
                  f"{rb['k1_ms']:.3f} ms, begin+update {rb['wall_ms']:.1f} ms "
                  f"(host clock), peak {rb['peak'] / 2 ** 30:.3f} GiB, tile "
                  f"bytes {rb['local_bytes']} of {rb['whole_bytes']}, "
                  f"collectives {rb['stats']} on {card}")
        print(f"dist (b): qwen2-0.5b full-width tile bank, one begin_step and "
              f"update on 2 ranks gathered == one process on all "
              f"{b[0]['equal']} leaves")
        c = [r["c"] for r in pair]
        hist = c[0]["hist"]
        losses = [m["loss"] for m in hist]
        check([m["step"] for m in hist] == list(range(DIST_STEPS)),
              f"dist (c): steps {[m['step'] for m in hist]}")
        check(all(math.isfinite(x) for x in losses), "dist (c): loss not finite")
        # a trend only: the held numbers are steps 0-1 against phase 10a
        # (the same weights, batches and learning rate) and the restore
        check(statistics.mean(losses[1:]) < losses[0],
              f"dist (c): loss did not fall {losses}")
        gaps = [abs(x / y - 1) for x, y in zip(losses[:2], lm_losses[:2])]
        check(max(gaps) < 1e-3, f"dist (c): steps 0-1 loss {losses[:2]} vs "
              f"phase 10a's {lm_losses[:2]}")
        check(all(r["restored"] for r in c), "dist (c): run B did not restore")
        check(c[0]["prints"] == c[1]["prints"], "dist (c): ranks gathered "
              "different states")
        med = statistics.median(m["step_s"] for m in hist[1:]) * 1e3
        for r, rc in enumerate(c):
            s = rc["stats"].get("grad_all_reduce", {})
            print(f"dist (c) rank {r}: peak allocated "
                  f"{rc['peak'] / 2 ** 30:.3f} GiB, tile state "
                  f"{rc['tile_bytes']} bytes, K1 launches {rc['launches']}, "
                  f"gradient all-reduce {s.get('seconds', 0) * 1e3 / DIST_STEPS:.1f}"
                  f" ms a step ({s.get('bytes', 0) / DIST_STEPS / 1e9:.3f} GB "
                  f"a step), collectives {rc['stats']} on {card}")
        print(f"dist (c): qwen2-0.5b full width and depth, --data-parallel 2, "
              f"loss {losses}, steps 0-1 {gaps[0]:.3e} / {gaps[1]:.3e} "
              f"(relative) from phase 10a's one rank; median {med:.2f} "
              f"ms/step (steps 1-3, host clock) on {card}")
        rs = c[0]["restore"]
        check(rs["equal"] > 0, "dist (c): the one-process restore differs "
              "from the ranks' gathered state at step 2")
        check(math.isfinite(rs["loss"]), "dist (c): one-process step not "
              "finite")
        print(f"dist (c): the 2-rank step-2 checkpoint restored in one "
              f"process (no mesh) equal to the ranks' gathered state on all "
              f"{rs['equal']} leaves; its step 2 loss {rs['loss']:.6f} "
              f"against the ranks' {losses[2]:.6f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d = dist_spawn(4, dist_ref_bank, timeout=300)
    cname = "g8x8_float32_Mn+g8x8_float32_nM"
    for r in d:
        check(r["names"] == ["g8x8_float32_Mn", "g8x8_float32_nM"]
              and r["classes"] == [cname], f"dist (d): groups {r['names']}")
        check(r["w_spec"] == (None, "data", None, None)
              and r["t_spec"] == (None, None), f"dist (d): specs {r}")
        check(r["per_dev"] <= r["total"] / 2 + 1024, f"dist (d): bytes {r}")
        check(math.isfinite(r["loss"]), "dist (d): loss")
    check(d[0]["equal"] > 0, "dist (d): nothing compared")
    print(f"dist (d): the reference's 2x2 bank on 4 ranks: specs W "
          f"{d[0]['w_spec']}, t {d[0]['t_spec']}; {d[0]['per_dev']} of "
          f"{d[0]['total']} tile bytes a rank; 2 steps == one process on "
          f"{d[0]['equal']} leaves")
    launches = (sum(r["b"]["launches"] + r["c"]["launches"] for r in pair)
                + sum(r["launches"] for r in d))
    print(f"dist: phase 15 took {time.time() - t0:.1f} s, {launches} K1 "
          f"launches in its sharded runs")
    return dict(launches=launches, step_ms=med)


# ---------------------------------------------------------------------------
# Phase 16: compute over the model axis (``--model-parallel``), ranks as in
# phase 15 (spawned, gloo, staged through host memory).
# (a) phase 10a's CLI run with --model-parallel 2 on two ranks sharing the
#     card, 3 steps: steps 0-1 within 1e-3 (relative) of phase 10a's
#     one-rank losses (step 0's learning rate is 0.1 under both
#     schedules); no model-group all-gather of a weight in the forward;
#     model-group all-reduce calls equal to ``tp_layout(...).all_reduces()``
#     a step, and K1 launches a rank to ``expected_k1`` (at data 1 every
#     rank updates every tile whole); prints ms/step, the model-group
#     all-reduces' ms and bytes a step, peak memory and tile bytes a rank,
#     and one ``loss_and_grads`` (the model's forward and backward with its
#     collectives) profiled on each rank against the same call of one
#     process at full width;
# (b) the smoke LM through the CLI on a (2, 2) mesh of four ranks sharing
#     the card, 3 steps, against the same four ranks on the CPU: loss
#     within rtol 1e-5, every float leaf of each rank's blocks within 1e-5
#     but for <= 0.1 % of its elements (phase 11a's standard).
TP_STEPS = 3
TP_SMOKE_ARGV = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "4", "--seq",
                 "16", "--steps", "3", "--log-every", "1",
                 "--data-parallel", "2", "--model-parallel", "2"]


def tp_batch():
    """Phase 10a's step-0 batch on the card."""
    import torch

    from repro_torch.data import BigramLM

    data = BigramLM(vocab=8192, seed=7)
    return {k: torch.as_tensor(v.copy()).to("cuda")
            for k, v in data.batch(0, 8, 128).items()}


def tp_model_ms(trainer, state, batch=None):
    """One ``loss_and_grads`` of ``batch`` (phase 10a's step-0 batch when
    None) after a warm-up call: (device ms of its kernels, device ms of its
    copies, model-group collectives counted in it), ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.distributed import runtime

    batch, key = batch or tp_batch(), prng.PRNGKey(9)
    trainer.loss_and_grads(state["params"], state["tiles"], batch, key)
    torch.cuda.synchronize()
    runtime.reset_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.loss_and_grads(state["params"], state["tiles"], batch, key)
        torch.cuda.synchronize()
    kern = copy = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copy += e.time_range.elapsed_us() / 1e3
        else:
            kern += e.time_range.elapsed_us() / 1e3
    stats = {k: dict(v) for k, v in runtime.STATS.items()}
    return kern, copy, stats


def tp_one_rank():
    """The one-process ``loss_and_grads`` at phase 10a's width on the card
    (state from the CLI's seeds)."""
    import torch

    from repro_torch import prng

    torch.cuda.empty_cache()
    model, one = _qwen_trainer(None)
    params = model.init(prng.PRNGKey(0), "cuda")
    state = one.init(prng.PRNGKey(1), params)
    del params
    kern, copy, _ = tp_model_ms(one, state)
    del state
    torch.cuda.empty_cache()
    return kern, copy


def tp_pair():
    """(a) on this rank."""
    import torch

    from repro_torch.distributed import runtime
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_stats()
    ops.reset_launch_counts()
    state, hist, _ = run_cli(LM_ARGV + ["--model-parallel", "2", "--steps",
                                        str(TP_STEPS), "--device", "cuda"])
    stats = {k: dict(v) for k, v in runtime.STATS.items()}
    launches = ops.LAUNCHES["analog_update"]
    peak = torch.cuda.max_memory_allocated()
    model, tr = _qwen_trainer(make_host_mesh(1, 2))
    tr.abstract_state(model.abstract_params("cuda"), "cuda")
    kern, copy, fb = tp_model_ms(tr, state)
    return dict(hist=hist, stats=stats, launches=launches, peak=peak,
                expected=expected_k1(tr, state["tiles"]) * TP_STEPS,
                all_reduces=tr.tp.all_reduces(),
                split=len(tr.tp.split), params=len(tr.tp.entries),
                tile_bytes=tile_state_bytes(state), kern_ms=kern,
                copy_ms=copy, fb=fb)


def tp_mesh_smoke():
    """(b) on this rank: the smoke CLI on the (2, 2) mesh on the card, then
    on the CPU; this rank's blocks of both final states compared."""
    from repro_torch.core.paths import flatten_with_path

    runs = {}
    for device in ("cuda", "cpu"):
        state, hist, _ = run_cli(TP_SMOKE_ARGV + ["--device", device])
        runs[device] = (dict(flatten_with_path(state)), hist)
    (card, hist), (cpu, want) = runs["cuda"], runs["cpu"]
    off, worst = leaves_off(card, cpu)
    return dict(hist=hist, want=want, leaves=len(cpu), off=off, worst=worst)


def leaves_off(card: dict, cpu: dict):
    """(leaves of ``cpu`` that ``card`` misses, the largest share of a
    leaf's elements off): a float leaf misses when more than 0.1 % of its
    elements are past 1e-5, an integer leaf when it differs at all."""
    import torch

    off = worst = 0
    for p, v in cpu.items():
        c = card[p].cpu()
        if not v.is_floating_point():
            off += int(not torch.equal(c, v))
            continue
        bad = (c.double() - v.double()).abs() > 1e-5
        off += int(bad.double().mean() > 1e-3)
        worst = max(worst, float(bad.double().mean()))
    return off, worst


def phase_tp(card: str, lm_losses):
    """Phase 16 (see above); ``lm_losses``: phase 10a's one-rank losses.
    Returns the K1 launches of (a) and its ms/step."""
    import torch

    t0 = time.time()
    torch.cuda.synchronize()
    one_kern, one_copy = tp_one_rank()
    pair = dist_spawn(2, tp_pair)
    hist = pair[0]["hist"]
    losses = [m["loss"] for m in hist]
    check([m["step"] for m in hist] == list(range(TP_STEPS)),
          f"tp (a): steps {[m['step'] for m in hist]}")
    check(all(math.isfinite(x) for x in losses), "tp (a): loss not finite")
    gaps = [abs(x / y - 1) for x, y in zip(losses[:2], lm_losses[:2])]
    check(max(gaps) < 1e-3, f"tp (a): steps 0-1 loss {losses[:2]} vs phase "
          f"10a's {lm_losses[:2]}")
    med = statistics.median(m["step_s"] for m in hist[1:]) * 1e3
    for r, rp in enumerate(pair):
        st = rp["stats"]
        weights = [k for k in st if k.startswith("model/all_gather/weights")]
        check(not weights, f"tp (a) rank {r}: the forward gathered weights "
              f"over the model axis: {weights}")
        ar = {f: sum(v[f] for k, v in st.items()
                     if k.startswith("model/all_reduce"))
              for f in ("calls", "bytes", "seconds")}
        check(ar["calls"] == rp["all_reduces"] * TP_STEPS,
              f"tp (a) rank {r}: {ar['calls']} model-group all-reduces, "
              f"tp_layout predicts {rp['all_reduces']} x {TP_STEPS}")
        fb = {f: sum(v[f] for k, v in rp["fb"].items()
                     if k.startswith("model/all_reduce"))
              for f in ("calls", "seconds")}
        check(fb["calls"] == rp["all_reduces"],
              f"tp (a) rank {r}: {fb['calls']} all-reduces in one "
              f"loss_and_grads, predicted {rp['all_reduces']}")
        check(rp["launches"] == rp["expected"],
              f"tp (a) rank {r}: {rp['launches']} K1 launches, expected "
              f"{rp['expected']}")
        gg = st.get("model/all_gather/grads", {})
        mg = {f: sum(v[f] for k, v in st.items()
                     if k.startswith("model/all_gather")
                     and not k.endswith("/grads"))
              for f in ("calls", "bytes", "seconds")}
        print(f"tp (a) rank {r}: {rp['split']} of {rp['params']} parameters "
              f"split; model-group all-reduces {ar['calls'] // TP_STEPS} a "
              f"step (tp_layout: {rp['all_reduces']}), "
              f"{ar['seconds'] * 1e3 / TP_STEPS:.1f} ms and "
              f"{ar['bytes'] / TP_STEPS / 1e6:.2f} MB a step (host clock, "
              f"staged); split gradients gathered "
              f"{gg.get('seconds', 0) * 1e3 / TP_STEPS:.1f} ms and "
              f"{gg.get('bytes', 0) / TP_STEPS / 1e9:.3f} GB a step; the "
              f"update's model-axis gathers {mg['calls'] // TP_STEPS} calls, "
              f"{mg['bytes'] / TP_STEPS / 1e9:.3f} GB, "
              f"{mg['seconds'] * 1e3 / TP_STEPS:.1f} ms a step; 0 weight "
              f"gathers in the forward; K1 launches {rp['launches']} "
              f"(expected {rp['expected']}); peak allocated "
              f"{rp['peak'] / 2 ** 30:.3f} GiB, tile state "
              f"{rp['tile_bytes']} bytes on {card}")
        print(f"tp (a) rank {r}: one loss_and_grads (forward and backward, "
              f"profiled): kernels {rp['kern_ms']:.3f} ms, copies "
              f"{rp['copy_ms']:.3f} ms of device time, its {fb['calls']} "
              f"all-reduces {fb['seconds'] * 1e3:.1f} ms host clock; one "
              f"process: kernels {one_kern:.3f} ms, copies {one_copy:.3f} ms "
              f"on {card}")
    print(f"tp (a): qwen2-0.5b full width and depth, --model-parallel 2 on 2 "
          f"ranks sharing the card, loss {losses}, steps 0-1 {gaps[0]:.3e} / "
          f"{gaps[1]:.3e} (relative) from phase 10a's one rank; median "
          f"{med:.2f} ms/step (steps 1-2, host clock) on {card}")
    quad = dist_spawn(4, tp_mesh_smoke, timeout=300)
    for r, q in enumerate(quad):
        got = [m["loss"] for m in q["hist"]]
        want = [m["loss"] for m in q["want"]]
        check(len(got) == len(want) == 3 and all(
            abs(a / b - 1) <= 1e-5 for a, b in zip(got, want)),
            f"tp (b) rank {r}: card {got} vs CPU {want}")
        check(q["off"] == 0, f"tp (b) rank {r}: {q['off']} of {q['leaves']} "
              f"leaves past 1e-5 on > 0.1 % of their elements")
    gaps = [abs(m["loss"] / w["loss"] - 1)
            for m, w in zip(quad[0]["hist"], quad[0]["want"])]
    print(f"tp (b): the smoke LM on a (2, 2) mesh of 4 ranks, card == CPU: "
          f"loss gaps {[f'{g:.2e}' for g in gaps]} (rtol 1e-5), "
          f"{quad[0]['leaves']} leaves a rank within 1e-5 but for at most "
          f"{max(q['worst'] for q in quad):.2e} of their elements on {card}")
    launches = sum(r["launches"] for r in pair)
    print(f"tp: phase 16 took {time.time() - t0:.1f} s, {launches} K1 "
          f"launches in (a) on {card}")
    return dict(launches=launches, step_ms=med)


# Phase 17: the model axis for MLA, RG-LRU, Mamba-2 SSD, cross-attention
# and the encoder-decoder, ranks as in phase 16.
# (a) MiniCPM3-4B (MLA, expanded as configured) and (b) Mamba2-2.7B (SSD,
#     one group: B/C stored split, read whole) at full width, depth cut to
#     4 layers (``step_profile.cut_depth``) so that two ranks fit on the
#     card, through the CLI's trainer (``make_trainer``: bf16 hash tiles,
#     batch 8, tokens from the first 8192 ids, seq 128 / 512), 2 steps with
#     --model-parallel 2 on two ranks sharing the card against one rank of
#     the same depth in this phase: steps 0-1 within 1e-3 (relative);
#     model-group all-reduce calls a step equal to
#     ``tp_layout(...).all_reduces()``; no model-group all-gather of a
#     split weight in the forward (``model/all_gather/weights``; a weight
#     stored split but read whole gathers as ``model/all_gather/whole``);
#     K1 launches a rank as the bank predicts; prints ms/step, the
#     all-reduces' ms a step, peak memory and tile bytes a rank, and one
#     ``loss_and_grads`` profiled a rank against the one rank's;
# (c) the smoke RecurrentGemma-9B, SeamlessM4T (fed frames) and
#     DeepSeek-V2 on (1, 2), phase 11a's batches, 3 steps on the card
#     against the same ranks on the CPU from one state: loss within rtol
#     1e-5, every float leaf of the rank's blocks within 1e-5 but for
#     <= 0.1 % of its elements. RecurrentGemma-9B and SeamlessM4T stay at
#     smoke size: their 256 K-id vocabularies at full width make two ranks
#     on one card too large for the phase's time.
MIX_TP = [("minicpm3-4b", 128), ("mamba2-2.7b", 512)]
MIX_TP_LAYERS, MIX_TP_STEPS = 4, 2
MIX_TP_SMOKE = ["recurrentgemma-9b", "seamless-m4t-large-v2",
                "deepseek-v2-236b"]


def mix_tp_batch(step: int, seq: int):
    """The bigram batch of ``step`` (8 rows, the first 8192 ids) on the
    card."""
    import torch

    from repro_torch.data import BigramLM

    data = BigramLM(vocab=8192, seed=7)
    return {k: torch.as_tensor(v.copy()).to("cuda")
            for k, v in data.batch(step, FULL_BATCH, seq).items()}


def mix_tp_run(arch: str, seq: int, mesh):
    """(a) or (b) in this process: one rank (``mesh`` None) or this rank of
    the (1, 2) mesh. Returns the losses and step seconds, the collectives
    and K1 launches counted over the steps, the peak memory, the tile
    bytes held and the profiled ``loss_and_grads``."""
    import gc

    import torch

    from repro_torch import prng
    from repro_torch.benchmarks.step_profile import cut_depth
    from repro_torch.configs import get_config
    from repro_torch.distributed import runtime
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cut_depth(get_config(arch), MIX_TP_LAYERS))
    tr = train.make_trainer(model, "erider", False, MIX_TP_STEPS, mesh=mesh)
    state = tr.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), "cuda"))
    bank = state["tiles"]
    n_paths = sum(len(ps) for _, ps in bank.index)
    runtime.reset_stats()
    ops.reset_launch_counts()
    hist = []
    for s in range(MIX_TP_STEPS):
        batch = mix_tp_batch(s, seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        torch.cuda.synchronize()
        hist.append(dict(loss=float(m["loss"]),
                         step_s=time.perf_counter() - t0))
    stats = {k: dict(v) for k, v in runtime.STATS.items()}
    launches = ops.LAUNCHES["analog_update"]
    peak = torch.cuda.max_memory_allocated()
    out = dict(hist=hist, stats=stats, launches=launches, peak=peak,
               tile_bytes=tile_state_bytes(state), n_paths=n_paths)
    if mesh is not None:
        out.update(expected=expected_k1(tr, state["tiles"]) * MIX_TP_STEPS,
                   all_reduces=tr.tp.all_reduces(), split=len(tr.tp.split),
                   params=len(tr.tp.entries))
    else:
        out.update(expected=2 * n_paths * MIX_TP_STEPS)
    kern, copy, fb = tp_model_ms(tr, state, mix_tp_batch(0, seq))
    out.update(kern_ms=kern, copy_ms=copy, fb=fb)
    del state, bank, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mix_tp_smoke(arch: str, mesh):
    """(c) for one arch on this rank: the CLI's smoke trainer on the mesh,
    its state drawn on the CPU, 3 steps on the card and on the CPU."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    model = LM(get_config(arch, smoke=True))
    tr = train.make_trainer(model, "erider", True, LM_CHECK_STEPS, mesh=mesh)
    cpu = tr.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), "cpu"))
    batches = zoo_batches(model.cfg, LM_CHECK_STEPS)
    runs = {}
    for device, st in (("cuda", to_device(cpu, "cuda")), ("cpu", cpu)):
        ops.reset_launch_counts()
        hist = []
        for b in batches:
            st, m = tr.train_step(st, {k: v.to(device) for k, v in b.items()})
            hist.append(float(m["loss"]))
        runs[device] = (dict(flatten_with_path(st)), hist,
                        ops.LAUNCHES["analog_update"])
    (card, hist, launches), (want, cpu_hist, _) = runs["cuda"], runs["cpu"]
    off, worst = leaves_off(card, want)
    return dict(hist=hist, want=cpu_hist, leaves=len(want), off=off,
                worst=worst, launches=launches, split=len(tr.tp.split))


def mix_tp_pair():
    """(a), (b) and (c) on this rank of the (1, 2) mesh, with half the
    host's cores (the two ranks share them); the seconds each took."""
    import torch

    from repro_torch.distributed.sharding import logical_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_shard_rules

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    mesh = make_host_mesh(1, 2)
    set_shard_rules(logical_rules(mesh))
    out, secs = {"smoke": {}}, {}
    for arch, seq in MIX_TP:
        t0 = time.time()
        out[arch] = mix_tp_run(arch, seq, mesh)
        secs[arch] = time.time() - t0
    for arch in MIX_TP_SMOKE:
        t0 = time.time()
        out["smoke"][arch] = mix_tp_smoke(arch, mesh)
        secs[arch] = time.time() - t0
    out["seconds"] = secs
    return out


def phase_tp_mixers(card: str):
    """Phase 17 (see above). Returns its K1 launches and (a)'s and (b)'s
    ms/step."""
    import torch

    t0 = time.time()
    torch.cuda.synchronize()
    one = {arch: mix_tp_run(arch, seq, None) for arch, seq in MIX_TP}
    t_one = time.time() - t0
    pair = dist_spawn(2, mix_tp_pair)
    launches = sum(o["launches"] for o in one.values())
    step_ms = {}
    for tag, (arch, seq) in zip("ab", MIX_TP):
        base = one[arch]
        want = [h["loss"] for h in base["hist"]]
        check(base["launches"] == base["expected"],
              f"tp_mixers ({tag}) one rank: {base['launches']} K1 launches, "
              f"expected {base['expected']}")
        base_ms = statistics.median(h["step_s"] for h in base["hist"][1:]) * 1e3
        for r, rp in enumerate(pair):
            res = rp[arch]
            got = [h["loss"] for h in res["hist"]]
            check(len(got) == MIX_TP_STEPS
                  and all(math.isfinite(x) for x in got),
                  f"tp_mixers ({tag}) rank {r}: losses {got}")
            gaps = [abs(x / y - 1) for x, y in zip(got[:2], want[:2])]
            check(max(gaps) < 1e-3, f"tp_mixers ({tag}) rank {r}: steps 0-1 "
                  f"loss {got[:2]} vs one rank's {want[:2]}")
            st = res["stats"]
            weights = [k for k in st
                       if k.startswith("model/all_gather/weights")]
            check(not weights, f"tp_mixers ({tag}) rank {r}: a split weight "
                  f"gathered over the model axis: {weights}")
            ar = {f: sum(v[f] for k, v in st.items()
                         if k.startswith("model/all_reduce"))
                  for f in ("calls", "bytes", "seconds")}
            check(ar["calls"] == res["all_reduces"] * MIX_TP_STEPS,
                  f"tp_mixers ({tag}) rank {r}: {ar['calls']} model-group "
                  f"all-reduces, tp_layout predicts {res['all_reduces']} x "
                  f"{MIX_TP_STEPS}")
            fb = {f: sum(v[f] for k, v in res["fb"].items()
                         if k.startswith("model/all_reduce"))
                  for f in ("calls", "seconds")}
            check(fb["calls"] == res["all_reduces"],
                  f"tp_mixers ({tag}) rank {r}: {fb['calls']} all-reduces in "
                  f"one loss_and_grads, predicted {res['all_reduces']}")
            check(res["launches"] == res["expected"],
                  f"tp_mixers ({tag}) rank {r}: {res['launches']} K1 "
                  f"launches, expected {res['expected']}")
            whole = st.get("model/all_gather/whole", {})
            gg = st.get("model/all_gather/grads", {})
            upd = {f: sum(v[f] for k, v in st.items()
                          if k.startswith("model/all_gather")
                          and not k.endswith(("/grads", "/whole")))
                   for f in ("calls", "bytes", "seconds")}
            med = statistics.median(h["step_s"] for h in res["hist"][1:]) * 1e3
            step_ms[arch] = med
            print(f"tp_mixers ({tag}) rank {r}: {arch}, {MIX_TP_LAYERS} "
                  f"layers, seq {seq}: {res['split']} of {res['params']} "
                  f"parameters split; model-group all-reduces "
                  f"{ar['calls'] // MIX_TP_STEPS} a step (tp_layout: "
                  f"{res['all_reduces']}), {ar['seconds'] * 1e3 / MIX_TP_STEPS:.1f}"
                  f" ms and {ar['bytes'] / MIX_TP_STEPS / 1e6:.2f} MB a step "
                  f"(host clock, staged); weights read whole gathered "
                  f"{whole.get('calls', 0) // MIX_TP_STEPS} calls, "
                  f"{whole.get('bytes', 0) / MIX_TP_STEPS / 1e6:.2f} MB a step; "
                  f"split gradients gathered "
                  f"{gg.get('seconds', 0) * 1e3 / MIX_TP_STEPS:.1f} ms and "
                  f"{gg.get('bytes', 0) / MIX_TP_STEPS / 1e9:.3f} GB a step; "
                  f"the update's model-axis gathers {upd['calls'] // MIX_TP_STEPS}"
                  f" calls, {upd['bytes'] / MIX_TP_STEPS / 1e9:.3f} GB, "
                  f"{upd['seconds'] * 1e3 / MIX_TP_STEPS:.1f} ms a step; 0 "
                  f"split-weight gathers in the forward; K1 launches "
                  f"{res['launches']} (expected {res['expected']}); peak "
                  f"allocated {res['peak'] / 2 ** 30:.3f} GiB (one rank: "
                  f"{base['peak'] / 2 ** 30:.3f}), tile state "
                  f"{res['tile_bytes']} bytes (one rank: {base['tile_bytes']})"
                  f" on {card}")
            print(f"tp_mixers ({tag}) rank {r}: one loss_and_grads (forward "
                  f"and backward, profiled): kernels {res['kern_ms']:.3f} ms, "
                  f"copies {res['copy_ms']:.3f} ms of device time, its "
                  f"{fb['calls']} all-reduces {fb['seconds'] * 1e3:.1f} ms host"
                  f" clock; one rank: kernels {base['kern_ms']:.3f} ms, copies "
                  f"{base['copy_ms']:.3f} ms on {card}")
            launches += res["launches"]
        print(f"tp_mixers ({tag}): {arch} full width, {MIX_TP_LAYERS} layers, "
              f"batch {FULL_BATCH} x seq {seq}, --model-parallel 2 on 2 ranks "
              f"sharing the card, loss {got}, steps 0-1 {gaps[0]:.3e} / "
              f"{gaps[1]:.3e} (relative) from one rank's {want}; median "
              f"{step_ms[arch]:.2f} ms/step against one rank's "
              f"{base_ms:.2f} (step 1, host clock) on {card}")
    for arch in MIX_TP_SMOKE:
        for r, rp in enumerate(pair):
            q = rp["smoke"][arch]
            check(len(q["hist"]) == len(q["want"]) == LM_CHECK_STEPS and all(
                abs(a / b - 1) <= 1e-5 for a, b in zip(q["hist"], q["want"])),
                f"tp_mixers (c) {arch} rank {r}: card {q['hist']} vs CPU "
                f"{q['want']}")
            check(q["off"] == 0, f"tp_mixers (c) {arch} rank {r}: {q['off']} "
                  f"of {q['leaves']} leaves past 1e-5 on > 0.1 % of their "
                  f"elements")
            check(q["split"] > 0, f"tp_mixers (c) {arch}: nothing split")
            launches += q["launches"]
        q = pair[0]["smoke"][arch]
        gaps = [abs(a / b - 1) for a, b in zip(q["hist"], q["want"])]
        print(f"tp_mixers (c): {arch} smoke on (1, 2), {q['split']} "
              f"parameters split, card == CPU: loss gaps "
              f"{[f'{g:.2e}' for g in gaps]} (rtol 1e-5), {q['leaves']} leaves "
              f"a rank within 1e-5 but for at most "
              f"{max(p['smoke'][arch]['worst'] for p in pair):.2e} of their "
              f"elements on {card}")
    secs = ", ".join(f"{a} {t:.1f}" for a, t in pair[0]["seconds"].items())
    print(f"tp_mixers: phase 17 took {time.time() - t0:.1f} s (one rank's "
          f"(a) and (b) {t_one:.1f} s; rank 0's parts: {secs} s), {launches} "
          f"K1 launches on {card}")
    return dict(launches=launches, step_ms=step_ms)


# ---------------------------------------------------------------------------
# 18. analysis: the graph contracts, the dry run and the K2 tickets
# ---------------------------------------------------------------------------
# The entrypoints whose step must make no synchronizing call on the card
# (``torch.cuda.set_sync_debug_mode("error")`` raises on one)
SYNC_FREE = ("begin_step", "prefill_commit", "prefill_commit_batch",
             "serve_step_lanes", "serve_step_lanes_gdc")
# a mutant on one entrypoint each, and the rule that must catch it
CARD_MUTANTS = [("restack", "train_step_fused", "restack"),
                ("no_donate", "train_step_scanned", "donation"),
                ("host_transfer", "serve_step_lanes", "host-transfer"),
                ("f64", "prefill_commit_batch", "dtype")]
# the production cells accounted on the host (arch, shape, multi_pod): a
# train cell and a serve cell whose body state the reference splits over
# its period axis (mamba2-2.7b's train cell took 35-44 s of the host)
DRY_CELLS = [("qwen2-0.5b", "train_4k", False),
             ("mamba2-2.7b", "decode_32k", True),
             ("gemma3-4b", "long_500k", False)]
DRY_PEAK_RTOL = 0.10
# (d)/(e): Qwen2-0.5B's fixed serve path, batch 8, a 128-token prompt and
# 16 greedy tokens (the cache holds 144 slots)
SERVE_MP = dict(batch=8, prompt=128, gen=16)
# (f): gemma3-4b at full width cut to 16 layers (two periods of five local
# layers and a global one, then the four-layer local tail) at batch 1 on
# the two data ranks of a (2, 1) mesh: the body caches split their period
# axis, the tail's 1024-slot rings their sequence. (i) a 4096-token prompt
# (the rings wrap four times) and 8 greedy tokens; (ii) one step at the
# last position of a 524288-slot cache filled from seeds, fed ``token``
LONG = dict(layers=16, prompt=4096, gen=8, seq=524288, token=4242)
# (ii): the logits and the cache slots the step wrote, ranks against one
# process, within this many bfloat16 ULPs of their amax
LONG_ULPS = 8


def sync_errors():
    """A context in which a synchronizing CUDA call raises."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return ctx


def k2_two_streams(calls: int = 20):
    """K2 on two streams at once at (896, 4864), different data: every
    call's sums bit-equal to ``sums_in_launch_order``. Returns the
    launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import sp_filter as k

    shape = (896, 4864)
    kw = dict(eta=0.3, tau_min=0.7, tau_max=1.3)
    f32 = torch.float32
    data = [sp_operands(shape, (f32, f32), seed, "cuda") for seed in (31, 32)]
    want = [k.sums_in_launch_order(*o, plan=k.launch_plan(o[0].numel(), True),
                                   **kw) for o in data]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            torch.cuda._sleep(20_000_000)  # both queues fill, then run
    before = ops.LAUNCHES["sp_filter"]
    outs = [[], []]
    for _ in range(calls):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(ops.sp_filter(*data[i], **kw))
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["sp_filter"] - before
    equal = sum(torch.equal(gp, want[i][0]) and torch.equal(err, want[i][1])
                for i in range(2) for _, gp, err in outs[i])
    check(launches == 2 * calls, f"analysis: K2 launches {launches}")
    check(equal == 2 * calls, f"analysis: K2 on two streams: {equal} of "
          f"{2 * calls} calls' sums bit-equal to the launch order")
    print(f"analysis: K2 on two streams at once, {calls} calls each at "
          f"{shape}: {equal} of {2 * calls} sums bit-equal to "
          f"sums_in_launch_order")
    return launches


def card_contracts(card: str):
    """(a): the seven contracts on CUDA tensors. Returns the K1 launches."""
    import torch

    from repro_torch.analysis import graph_contracts as gc
    from repro_torch.analysis.contracts import check_trace
    from repro_torch.kernels import ops
    from repro_torch.roofline.op_cost import analyze_trace

    launches = 0
    for name in sorted(gc.CONTRACTS):
        before = ops.LAUNCHES["analog_update"]
        before_ip = ops.LAUNCHES["analog_update_"]
        ctx = sync_errors() if name in SYNC_FREE else None
        tr, aliased = gc.trace_entrypoint(name, device="cuda", context=ctx)
        torch.cuda.synchronize()
        n = ops.LAUNCHES["analog_update"] - before
        check(ops.LAUNCHES["analog_update_"] - before_ip == n,
              f"analysis: {name}: K1 launches not all in place")
        launches += n
        res = check_trace(gc.CONTRACTS[name], tr, aliased, check_hbm=False)
        st = res.stats
        k1 = len(tr.kernel_records("analog_update"))
        print(f"analysis: {name}: {st['ops']} ops, {st['uploads']} uploads "
              f"({st['upload_bytes']} B), {st['host_transfer_ops']} host "
              f"reads, {k1} K1 records, {st['restacks']} restacks, "
              f"{aliased} leaves in place, {analyze_trace(tr).bytes:.0f} B "
              f"({'sync-free' if name in SYNC_FREE else 'no sync check'}) "
              f"on {card}")
        check(res.ok, f"analysis: {name} on the card: {res.violations}")
        check(n == k1, f"analysis: {name}: {n} K1 launches, {k1} records")
    for mutant, name, rule in CARD_MUTANTS:
        before = ops.LAUNCHES["analog_update"]
        res = gc.run_contract(name, mutant, device="cuda", check_hbm=False)
        torch.cuda.synchronize()
        launches += ops.LAUNCHES["analog_update"] - before
        rules = sorted({v["rule"] for v in res.violations})
        check(rule in rules, f"analysis: mutant {mutant} on {name}: {rules}")
        print(f"analysis: mutant {mutant} on {name} caught by {rules}")
    return launches


def serve_capture(card: str) -> None:
    """A CUDA graph capture of ``serve_step_lanes``: whether it captures and
    whether one replay equals the eager step bit for bit (a measurement
    for ROADMAP item 17b, not a gate)."""
    import torch

    from repro_torch.analysis import graph_contracts as gc
    from repro_torch.core.paths import leaves

    model, params, ecfg, paged, _ = gc._serve_setup("cuda")
    last, table, pos, live = gc._lanes_inputs(ecfg, "cuda")

    def step():
        return model.serve_step_lanes(params, last, paged, table, pos, live)

    toks, _ = step()
    want = [t.clone() for t in [toks] + leaves(paged)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            g_toks, _ = step()
    except Exception as e:  # noqa: BLE001 -- the measurement is the outcome
        print(f"analysis: serve_step_lanes does not capture in a CUDA graph: "
              f"{type(e).__name__}: {str(e)[:200]} on {card}")
        torch.cuda.synchronize()
        return
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b)
               for a, b in zip([g_toks] + leaves(paged), want))
    t0 = time.perf_counter()
    for _ in range(20):
        graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"analysis: serve_step_lanes captures in a CUDA graph; one replay "
          f"{'equals' if same else 'differs from'} the eager step bit for "
          f"bit; {replay_ms:.3f} ms a replay against {eager_ms:.3f} ms eager "
          f"(smoke config, 4 lanes) on {card}")


def dry_vs_card(card: str, cli_peak=None):
    """(b): ``dryrun.account_step`` of phase 10a's CLI trainer (Qwen2-0.5B,
    full width and depth, batch 8, seq 128, one rank) on ``meta``, the
    donated step the CLI runs and the out-of-place one, beside
    ``max_memory_allocated`` of the donated step on the card (and the
    CLI's whole run in phase 10a, ``cli_peak``) and its tile bytes; then
    the same two steps out of place from the same init, every leaf and the
    loss bit-equal to the donated ones. Returns the K1 launches."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.data import BigramLM
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, train
    from repro_torch.models.lm import LM

    model = LM(get_config("qwen2-0.5b"))
    trainer = train.make_trainer(model, "erider", False, LM_STEPS)
    meta = dryrun.rank_tree(trainer.abstract_state(
        model.abstract_params("meta"), "meta"))
    mbatch = {k: torch.empty((8, 128), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    acc = dryrun.account_step(trainer, meta, mbatch)
    meta = dryrun.rank_tree(trainer.abstract_state(
        model.abstract_params("meta"), "meta"))
    pure_acc = dryrun.account_step(trainer, meta, mbatch, donate=False)
    del meta

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = ops.LAUNCHES["analog_update"]
    before_ip = ops.LAUNCHES["analog_update_"]
    params = model.init(prng.PRNGKey(0), "cuda")
    state = trainer.init(prng.PRNGKey(1), params)
    del params
    raw = BigramLM(vocab=8192, seed=7).batch(0, 8, 128)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in raw.items()}
    step = trainer.jit_step()
    state, m0 = step(state, batch)   # warm: the card's caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    tiles = tile_state_bytes(state)
    launches = ops.LAUNCHES["analog_update"] - before
    in_place = ops.LAUNCHES["analog_update_"] - before_ip
    losses = [float(m0["loss"]), float(metrics["loss"])]
    del metrics, m0
    # the same two steps out of place, from the same init
    params = model.init(prng.PRNGKey(0), "cuda")
    pure = trainer.init(prng.PRNGKey(1), params)
    del params
    pure_losses = []
    for _ in range(2):
        pure, m = trainer.train_step(pure, batch)
        pure_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["analog_update"] - before
    fa, fb = flatten_with_path(state), flatten_with_path(pure)
    same = ([p for p, _ in fa] == [p for p, _ in fb]
            and all(a.dtype == b.dtype and torch.equal(a, b)
                    for (_, a), (_, b) in zip(fa, fb)))
    del state, pure, m, batch, fa, fb
    torch.cuda.empty_cache()
    loss = losses[1]
    gap = acc["peak_bytes"] / peak - 1
    k1 = len(acc["trace"].kernel_records("analog_update"))
    cli = ("" if cli_peak is None else
           f"; phase 10a's whole CLI run {cli_peak} B "
           f"({cli_peak / 2 ** 30:.3f} GiB)")
    print(f"analysis: dry run of phase 10a's donated step: predicted peak "
          f"{acc['peak_bytes']} B ({acc['peak_bytes'] / 2 ** 30:.3f} GiB: "
          f"arguments {acc['argument_bytes']} + step {acc['temp_bytes']}; "
          f"out of place {pure_acc['peak_bytes']} B, "
          f"{pure_acc['peak_bytes'] / 2 ** 30:.3f} GiB), measured "
          f"max_memory_allocated {peak} B ({peak / 2 ** 30:.3f} GiB; "
          f"{resident} B resident before the step){cli}: {100 * gap:+.2f} %; "
          f"tile bytes predicted {acc['tile_state_bytes']}, measured {tiles}; "
          f"{acc['cost'].ops} ops, {k1} K1 records (card: {in_place // 2} "
          f"in-place launches a step), {acc['cost'].flops:.4e} flops, "
          f"{acc['cost'].bytes:.4e} B, traced in {acc['trace_s']:.1f} s on "
          f"the host; loss {loss:.4f} on {card}")
    print(f"analysis: phase 10a's step: two donated steps bit-equal to two "
          f"out-of-place steps from the same init on every leaf: {same}; "
          f"losses {losses} vs {pure_losses}")
    check(math.isfinite(loss), "analysis: the 10a step's loss")
    check(abs(gap) <= DRY_PEAK_RTOL, f"analysis: predicted peak "
          f"{acc['peak_bytes']} vs measured {peak} ({100 * gap:+.2f} %)")
    check(acc["tile_state_bytes"] == tiles,
          f"analysis: tile bytes {acc['tile_state_bytes']} vs {tiles}")
    check(in_place == 2 * k1, f"analysis: {in_place} in-place K1 launches in "
          f"two donated steps, {k1} records a step predicted")
    check(same and losses == pure_losses,
          "analysis: donated LM steps differ from out-of-place ones")
    return launches


def serve_mp_inputs():
    """Qwen2-0.5B at full width and depth from ``LM.init``'s seed on the
    card, and (d)'s seeded prompts."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    model = LM(get_config("qwen2-0.5b"))
    params = model.init(prng.PRNGKey(0), "cuda")
    tokens = np.random.default_rng(23).integers(
        0, 8192, (SERVE_MP["batch"], SERVE_MP["prompt"])).astype(np.int32)
    return model, params, torch.from_numpy(tokens).cuda()


def serve_mp_rank():
    """(d) on this rank: ``fixed_generate`` on the (1, 2) mesh, each rank
    from its blocks of the weights and the ``head_dim``-split cache."""
    import torch

    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import fixed_generate

    model, params, tokens = serve_mp_inputs()
    runtime.reset_stats()
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = fixed_generate(model, params, tokens, SERVE_MP["gen"],
                             mesh=make_host_mesh(1, 2), stats=stats)
    torch.cuda.synchronize()
    return dict(tokens=toks.cpu(), stats=stats,
                seconds=time.perf_counter() - t0)


def model_group(before: dict, after: dict):
    """(calls, bytes) of the model-group collectives between two copies of
    ``runtime.STATS``."""
    calls = nbytes = 0
    for k, v in after.items():
        if k.startswith("model/"):
            calls += v["calls"] - before.get(k, {}).get("calls", 0)
            nbytes += v["bytes"] - before.get(k, {}).get("bytes", 0)
    return calls, nbytes


def serve_mp(card: str) -> None:
    """(d) and (e): Qwen2-0.5B's fixed serve path in one process on the
    card (tokens, and one ``serve_step``'s ``max_memory_allocated`` beside
    ``dryrun.account_serve`` of the same step on ``meta``), then on two
    model ranks of a (1, 2) mesh sharing the card: tokens identical."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import fixed_generate

    B, S, G = SERVE_MP["batch"], SERVE_MP["prompt"], SERVE_MP["gen"]
    t0 = time.time()
    model, params, tokens = serve_mp_inputs()
    want, _ = fixed_generate(model, params, tokens, G)
    cache = model.init_cache(B, S + G, device="cuda")
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    tok = model.greedy(logits)
    del logits
    tok, cache = model.serve_step(params, tok, cache, S)    # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    tok, cache = model.serve_step(params, tok, cache, S + 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    asked = torch.cuda.memory_stats()["requested_bytes.all.peak"] - asked
    del params, cache, tok
    torch.cuda.empty_cache()
    acc = dryrun.account_serve(
        model, dryrun.rank_tree(model.abstract_params("meta")),
        dryrun.rank_tree(model.init_cache(B, S + G, abstract=True,
                                          device="meta")),
        {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")},
        kind="decode", pos=S + 1)
    # The gate holds the step's storages to the bytes the step requested:
    # max_memory_allocated counts allocator blocks, and a free block left
    # by earlier phases may serve a large request whole (the caching
    # allocator splits a block only if over 1 MiB would remain), so its
    # rise depends on what ran before (one run: the 2430976 B logits in a
    # 2752512 B block).
    grew = peak - resident
    gap = acc["temp_bytes"] / asked - 1
    print(f"analysis: (e) dry run of Qwen2-0.5B's serve_step (batch {B}, "
          f"cache {S + G}): predicted arguments {acc['argument_bytes']} B + "
          f"step {acc['temp_bytes']} B = peak {acc['peak_bytes']} B; "
          f"measured {resident} B resident, max_memory_allocated {peak} B, "
          f"a rise of {grew} B, {asked} B requested: step "
          f"{100 * gap:+.2f} % of the requested bytes, peak "
          f"{100 * (acc['peak_bytes'] / peak - 1):+.2f} %; {acc['cost'].ops} "
          f"ops on {card}")
    check(abs(gap) <= DRY_PEAK_RTOL, f"analysis: (e) predicted step bytes "
          f"{acc['temp_bytes']} vs requested {asked} ({100 * gap:+.2f} %)")
    t1 = time.time()
    ranks = dist_spawn(2, serve_mp_rank, timeout=600)
    for r, res in enumerate(ranks):
        same = torch.equal(res["tokens"], want.cpu())
        check(same, f"analysis: (d) rank {r}'s tokens differ from one "
              f"process's at {(res['tokens'] != want.cpu()).nonzero()[:4]}")
    pre, post = ranks[0]["stats"]
    p_calls, p_bytes = model_group({}, pre)
    d_calls, d_bytes = model_group(pre, post)
    steps = G - 1
    print(f"analysis: (d) Qwen2-0.5B fixed serve (batch {B}, prompt {S}, "
          f"{G} greedy tokens) on two model ranks of a (1, 2) mesh sharing "
          f"the card: {B * G} tokens identical to one process's; model "
          f"group a rank: prefill {p_calls} calls {p_bytes} B, decode "
          f"{d_calls / steps:.0f} calls {d_bytes / steps:.0f} B a step "
          f"({d_bytes / steps / B:.0f} B a token); {ranks[0]['seconds']:.1f} "
          f"s a rank for the run, (d)+(e) {time.time() - t0:.1f} s "
          f"({time.time() - t1:.1f} s spawned) on {card}")


def dry_cells(card: str) -> None:
    """(c): the two production cells, accounted on the host after the
    card's phases: the per-rank peak, the bottleneck and the roofline
    fraction on the H100's constants, the cache rows moved."""
    import contextlib
    import io

    from repro_torch.launch import dryrun

    out = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out, ignore_errors=True)
    try:
        for arch, shape, multi_pod in DRY_CELLS:
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                r = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                    out_dir=out)
            secs = time.time() - t0
            check(r["status"] == "ok", f"analysis: dry run {arch} {shape}: "
                  f"{r.get('error')}")
            roof, mem = r["roofline"], r["memory"]
            check(roof["hlo_flops"] > 0, f"analysis: dry run {arch}: no flops")
            tiles = (f", tiles {mem['tile_state_bytes']} B"
                     if "tile_state_bytes" in mem else "")
            moved = r["collectives"].get("cache/reshard", 0)
            print(f"analysis: dry run {arch} {shape} on {r['mesh']} (rank 0 "
                  f"of {roof['chips']}): peak {mem['peak_bytes']} B a rank "
                  f"({mem['peak_per_device_gb']} GiB; arguments "
                  f"{mem['argument_bytes']} B{tiles}), {r['ops']} ops, "
                  f"cache/reshard {moved} B, bottleneck "
                  f"{roof['bottleneck']} (compute {roof['t_compute']:.4f} s, "
                  f"memory {roof['t_memory']:.4f} s, collective "
                  f"{roof['t_collective']:.4f} s), roofline fraction "
                  f"{roof['roofline_fraction']:.5f}, useful "
                  f"{roof['useful_ratio']:.4f}; {secs:.1f} s on the host "
                  f"(H100 80GB HBM3 constants)")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def long_model():
    """(f)'s model: gemma3-4b at full width, depth cut to ``LONG["layers"]``
    (whole periods, the tail kept), weights from ``LM.init``'s seed on the
    card."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = get_config("gemma3-4b")
    body = LONG["layers"] - len(cfg.tail)
    cfg = dataclasses.replace(cfg, n_layers=LONG["layers"],
                              n_periods=body // len(cfg.pattern))
    model = LM(cfg)
    return model, model.init(prng.PRNGKey(0), "cuda")


def long_prompt():
    import numpy as np
    import torch

    tokens = np.random.default_rng(29).integers(0, 8192, (1, LONG["prompt"]))
    return torch.from_numpy(tokens.astype(np.int32)).cuda()


def seeded_leaf(i: int, leaf):
    """Cache leaf ``i``'s seeded values (standard normal in its dtype, from
    a generator of its own on the card), the same in every process."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1000 + i)
    return torch.randn(leaf.shape, generator=g, device="cuda",
                       dtype=leaf.dtype)


def long_cache(model):
    """(ii)'s whole cache on the card: every k/v leaf ``seeded_leaf``, every
    ``pos`` as a prefill of ``seq - 1`` tokens leaves it (a ring holds the
    last positions at slot position % Sc; the global cache's last slot is
    empty, the step writes it)."""
    import torch

    from repro_torch.core.paths import flatten_with_path

    S = LONG["seq"] - 1
    cache = model.init_cache(1, LONG["seq"], device="cuda")
    for i, (p, leaf) in enumerate(flatten_with_path(cache)):
        if p.endswith("/pos"):
            Sc = leaf.shape[-1]
            kpos = torch.arange(max(S - Sc, 0), S, dtype=torch.int32,
                                device="cuda")
            leaf[..., kpos % Sc] = kpos
        else:
            leaf.copy_(seeded_leaf(i, leaf))
    return cache


def long_written(cache, specs=None, mesh=None):
    """The step's writes in ``cache`` (this rank's blocks under ``specs``
    on ``mesh``, gathered leaf by leaf): {path: every ``pos`` leaf, the
    slot of the step's position of each k/v leaf (float32, on the host)},
    and {path: whether every other slot holds its seeded value}."""
    import torch

    from repro_torch.core.paths import flatten_with_path
    from repro_torch.distributed import sharding

    S = LONG["seq"] - 1
    written, rest = {}, {}
    for i, (p, leaf) in enumerate(flatten_with_path(cache)):
        if mesh is not None:
            leaf = sharding.gather(leaf, specs[p], mesh)
        if p.endswith("/pos"):
            written[p] = leaf.cpu()
            continue
        d = leaf.ndim - 3                   # the slots' dim
        Sc = leaf.shape[d]
        slot = S % Sc
        written[p] = leaf.select(d, slot).float().cpu()
        seeded = seeded_leaf(i, leaf)
        rest[p] = all(torch.equal(leaf.narrow(d, a, n), seeded.narrow(d, a, n))
                      for a, n in ((0, slot), (slot + 1, Sc - slot - 1)))
        del leaf, seeded
    return written, rest


def long_step(model, params, mesh=None):
    """(ii): one ``decode_step`` at position ``seq - 1`` of
    ``long_cache``, in one process or as this rank of ``mesh`` (its blocks
    of the weights and the cache, met as ``fixed_generate`` meets them).
    Returns the float32 logits, the greedy token and ``long_written``."""
    import torch

    from repro_torch.core.paths import flatten_with_path
    from repro_torch.distributed import sharding
    from repro_torch.launch.serve import mesh_axes

    S = LONG["seq"] - 1
    tok = torch.full((1, 1), LONG["token"], dtype=torch.int32, device="cuda")
    cache = long_cache(model)
    specs = None
    if mesh is None:
        logits, cache = model.decode_step(params, tok, cache, S)
    else:
        c_sh = sharding.cache_shardings(cache, mesh)
        p_sh = sharding.params_shardings(params, mesh)
        specs = {p: sh.spec for p, sh in flatten_with_path(c_sh)}
        cache = sharding.shard_tree(cache, c_sh)
        shards = sharding.CacheShards(c_sh, 1)
        with mesh_axes(mesh, 1):
            w = sharding.compute_params(sharding.shard_tree(params, p_sh),
                                        p_sh)
            logits, cache = model.decode_step(w, tok, cache, S, shards)
        del w
    token = int(model.greedy(logits)[0, 0])
    logits = logits[0, -1].float().cpu()
    written, rest = long_written(cache, specs, mesh)
    return dict(logits=logits, token=token, written=written, rest=rest)


def long_rank():
    """(f) on this rank of the (2, 1) mesh: (i) ``fixed_generate`` at batch
    1 (its tokens and ``runtime.STATS`` after prefill and after the last
    step), then (ii) ``long_step``."""
    import torch

    from repro_torch import convert
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import fixed_generate

    mesh = make_host_mesh(2, 1)
    # one rank at a time: ``LM.init``'s threefry chains over the 262144-row
    # embedding hold ~20 GB of the shared card while they run
    for r in range(runtime.world()):
        if r == runtime.rank():
            model, params = long_model()
            torch.cuda.empty_cache()
        runtime.barrier()
    runtime.reset_stats()
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = fixed_generate(model, params, long_prompt(), LONG["gen"],
                                 mesh=mesh, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del cache
    runtime.reset_stats()
    t0 = time.perf_counter()
    step = long_step(model, params, mesh)
    torch.cuda.synchronize()
    step.update(tokens=toks.cpu(), stats=stats, seconds=seconds,
                step_seconds=time.perf_counter() - t0,
                step_stats={k: dict(v) for k, v in runtime.STATS.items()},
                peak=torch.cuda.max_memory_allocated())
    # numpy, pickled by value: a tensor on the queue shares its storage
    # with this process, which may be gone by the time the parent reads it
    return convert.to_numpy(step)


def moved(before: dict, after: dict, label: str, steps: int = 1):
    """(calls, bytes) a step under ``label`` between two copies of
    ``runtime.STATS``."""
    a, b = after.get(label, {}), before.get(label, {})
    return ((a.get("calls", 0) - b.get("calls", 0)) / steps,
            (a.get("bytes", 0) - b.get("bytes", 0)) / steps)


def long_context(card: str) -> None:
    """(f): gemma3-4b at 16 layers, batch 1, in one process on the card,
    then on the two data ranks of a (2, 1) mesh sharing the card: (i) 8
    greedy tokens after a 4096-token prompt identical; (ii) one step at
    position 524287: the token equal or a near tie, the logits and the
    written slots within ``LONG_ULPS`` bf16 ULPs, every other slot its
    seeded value, ``pos`` equal; (iii) ``dryrun.account_serve`` of the one
    process's step on ``meta`` within 10 % of the rise of
    ``max_memory_allocated`` over the step."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import fixed_generate

    t0 = time.time()
    S, G = LONG["seq"] - 1, LONG["gen"]
    model, params = long_model()
    weights = torch.cuda.memory_allocated()
    want, cache = fixed_generate(model, params, long_prompt(), G)
    del cache
    t_i = time.time() - t0
    # (ii) and (iii): the step once for its logits and writes, then again
    # (the same slot, the same values) under a fresh peak
    one = long_step(model, params)
    tok = torch.full((1, 1), LONG["token"], dtype=torch.int32, device="cuda")
    cache = long_cache(model)
    model.serve_step(params, tok, cache, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    model.serve_step(params, tok, cache, S)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, cache, tok
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    acc = dryrun.account_serve(
        model, dryrun.rank_tree(model.abstract_params("meta")),
        dryrun.rank_tree(model.init_cache(1, LONG["seq"], abstract=True,
                                          device="meta")),
        {"tokens": torch.empty((1, 1), dtype=torch.int32, device="meta")},
        kind="decode", pos=S)
    grew = peak - resident
    gap = acc["temp_bytes"] / grew - 1
    print(f"analysis: (f)(iii) dry run of gemma3-4b's serve_step at 16 "
          f"layers, batch 1, position {S} of a {LONG['seq']}-slot cache: "
          f"predicted arguments {acc['argument_bytes']} B + step "
          f"{acc['temp_bytes']} B = peak {acc['peak_bytes']} B; measured "
          f"{weights} B allocated after the weights' init, "
          f"{resident} B resident, max_memory_allocated {peak} B, a rise of "
          f"{grew} B: step {100 * gap:+.2f} %, peak "
          f"{100 * (acc['peak_bytes'] / peak - 1):+.2f} %; {acc['cost'].ops} "
          f"ops on {card}")
    check(abs(gap) <= DRY_PEAK_RTOL, f"analysis: (f)(iii) predicted step "
          f"bytes {acc['temp_bytes']} vs measured {grew} ({100 * gap:+.2f} %)")
    t1 = time.time()
    ranks = dist_spawn(2, long_rank, timeout=600)
    for r, res in enumerate(ranks):
        same = torch.equal(torch.from_numpy(res["tokens"]), want.cpu())
        check(same, f"analysis: (f)(i) rank {r}'s tokens {res['tokens']} "
              f"differ from one process's {want.cpu()}")
        long_check(r, res, one)
    pre, post = ranks[0]["stats"]
    steps = G - 1
    r_calls, r_bytes = moved(pre, post, "cache/reshard", steps)
    m_calls, m_bytes = moved(pre, post, "attn/seq_merge", steps)
    p_calls, p_bytes = moved({}, pre, "cache/reshard")
    s_calls, s_bytes = moved({}, ranks[0]["step_stats"], "cache/reshard")
    sm_calls, sm_bytes = moved({}, ranks[0]["step_stats"], "attn/seq_merge")
    print(f"analysis: (f)(i) gemma3-4b at 16 layers, batch 1, prompt "
          f"{LONG['prompt']}, {G} greedy tokens on the two data ranks of a "
          f"(2, 1) mesh sharing the card: {G} of {G} tokens identical to one "
          f"process's ({t_i:.1f} s); a rank: prefill cache/reshard "
          f"{p_calls:.0f} calls {p_bytes:.0f} B; a decode step cache/reshard "
          f"{r_calls:.0f} calls {r_bytes:.0f} B, attn/seq_merge "
          f"{m_calls:.0f} calls {m_bytes:.0f} B; "
          f"{ranks[0]['seconds']:.1f} s a rank for the run")
    print(f"analysis: (f)(ii) the step at position {S} a rank: "
          f"cache/reshard {s_calls:.0f} calls {s_bytes:.0f} B, "
          f"attn/seq_merge {sm_calls:.0f} calls {sm_bytes:.0f} B, "
          f"{ranks[0]['step_seconds']:.1f} s (the cache gathered and checked "
          f"included), peak {ranks[0]['peak']} B a rank ({held} B reserved "
          f"by this process meanwhile); (f) "
          f"{time.time() - t0:.1f} s ({time.time() - t1:.1f} s spawned) on "
          f"{card}")


def long_check(rank: int, res: dict, one: dict) -> None:
    """(f)(ii)'s gates for one rank's step against one process's."""
    import torch

    label = f"analysis: (f)(ii) rank {rank}"
    a, b = torch.from_numpy(res["logits"]), one["logits"]
    err = float((a - b).abs().max())
    ulp = float(bf16_ulp(b.abs().max()))
    top = torch.topk(b, 2).values
    gap = float(top[0] - top[1])
    print(f"{label}: token {res['token']} / one process {one['token']} "
          f"(top-2 gap {gap:.6g} = {gap / float(bf16_ulp(top[0])):g} bf16 "
          f"ULP), logits max |diff| {err:.6g} = {err / ulp:g} bf16 ULP of "
          f"their amax {float(b.abs().max()):.6g}")
    check(res["token"] == one["token"]
          or gap <= 2 * float(bf16_ulp(top[0])),
          f"{label}: token {res['token']} vs {one['token']} without a "
          f"near-tie")
    check(err <= LONG_ULPS * ulp, f"{label}: logits differ by {err} "
          f"(> {LONG_ULPS} bf16 ULP of {float(b.abs().max())})")
    worst = 0.0
    for p, w in one["written"].items():
        g = torch.from_numpy(res["written"][p])
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{label}: {p} differs")
            continue
        e = float((g - w).abs().max()) / float(bf16_ulp(w.abs().max()))
        worst = max(worst, e)
        check(e <= LONG_ULPS, f"{label}: {p}'s written slot differs by {e:g} "
              f"bf16 ULP of its amax")
    bad = [p for p, ok in res["rest"].items() if not ok]
    check(not bad and all(one["rest"].values()),
          f"{label}: slots the step did not write changed: {bad}")
    print(f"{label}: written slots within {worst:g} bf16 ULP of one "
          f"process's, the {len(res['rest'])} k/v leaves' other slots and "
          f"every pos leaf equal")


def phase_analysis(card: str, cli_peak=None):
    """Phase 18 (see above); ``cli_peak``: phase 10a's peak, printed beside
    (b). Returns its K1 and K2 launches."""
    t0 = time.time()
    k2 = k2_two_streams()
    k1 = card_contracts(card)
    k1 += dry_vs_card(card, cli_peak)
    serve_mp(card)
    long_context(card)
    serve_capture(card)
    dry_cells(card)
    print(f"analysis: phase 18 took {time.time() - t0:.1f} s, {k1} K1 and "
          f"{k2} K2 launches on {card}")
    return dict(launches=k1, sp_launches=k2)


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
    sass_counts()
    record_k1_launches()

    kern, kern_ip = phase_kernels(device)
    k1_hash, normal, drawn = phase_kernels_hash(device)
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

    serve = phase_serve(card)
    print(f"serve: {serve['tokens_per_s']:.2f} tokens/s, decode step "
          f"{serve['step_ms']:.2f} ms on {card}")
    for arch, r in phase_serve_zoo(card).items():
        print(f"serve_zoo[{arch}]: {r['tokens_per_s']:.2f} tokens/s, decode "
              f"step {r['step_ms']:.2f} ms, {r['launches']:.0f} launches a "
              f"step, peak {r['peak_bytes'] / 2 ** 30:.3f} GiB on {card}")

    paper = phase_paper(card)
    dist = phase_dist(card, lm["losses"])
    print(f"dist: {dist['step_ms']:.2f} ms/step on 2 ranks on {card}")
    tp = phase_tp(card, lm["losses"])
    print(f"tp: {tp['step_ms']:.2f} ms/step on 2 model ranks on {card}")
    mix = phase_tp_mixers(card)
    for arch, ms in mix["step_ms"].items():
        print(f"tp_mixers[{arch}]: {ms:.2f} ms/step on 2 model ranks on "
              f"{card}")
    ana = phase_analysis(card, lm["peak_bytes"])

    # the divisors and noise scales of every K1 launch since phase 3 that
    # the configs did not name (none, where k1_configs is complete)
    k1_hash["exact_checks"] = exact_sweeps(sorted(K1_LAUNCHED), "end")
    kern["launches"] = (launches + lm["launches"] + zoo
                        + sum(r["launches"] for r in full.values())
                        + serve["train_launches"] + paper["launches"]
                        + dist["launches"] + tp["launches"]
                        + mix["launches"] + ana["launches"])
    kern["lm_launches"] = lm["launches"]
    kern["zoo_launches"] = zoo
    kern["paper_launches"] = paper["launches"]
    kern["dist_launches"] = dist["launches"]
    kern["tp_launches"] = tp["launches"]
    kern["tp_mixers_launches"] = mix["launches"]
    kern["analysis_launches"] = ana["launches"]
    spf["analysis_launches"] = ana["sp_launches"]
    spf["launches"] += ana["sp_launches"]
    kern["full_width"] = full
    # the hash kernels on the main path: phase 7's fused steps, 10a, 11b-c
    k1_hash["launches"] = (FCN_HASH["fused"] + lm["hash_launches"]
                           + sum(r["hash_launches"] for r in full.values()))
    k1_hash["fcn_launches"] = FCN_HASH["fused"]
    k1_hash["lm_launches"] = lm["hash_launches"]
    k1_hash["full_width_launches"] = {a: r["hash_launches"]
                                      for a, r in full.items()}
    # the device draws of the hash steps with drawn devices: 10a, 11b-c
    # and 12b's two training steps; training launches no hash_normal, the
    # aged loads of 12b draw the drift's normals through it
    drawn["launches"] = (lm["device_launches"] + serve["device_launches"]
                         + sum(r["device_launches"] for r in full.values()))
    drawn["lm_launches"] = lm["device_launches"]
    drawn["full_width_launches"] = {a: r["device_launches"]
                                    for a, r in full.items()}
    drawn["serve_train_launches"] = serve["device_launches"]
    normal["launches"] = serve["normal_launches"]
    normal["lm_launches"] = (lm["normal_launches"]
                             + sum(r["normal_launches"]
                                   for r in full.values()))
    print(json.dumps({"kernels": [
        dict(name="analog_update", route="cuda",
             source="src/repro_torch/kernels/csrc/analog_update.cu",
             replaces="src/repro/kernels/analog_update.py:72",
             bound_by="bytes", library_ms=None, **kern),
        dict(name="analog_update_", route="cuda",
             source="src/repro_torch/kernels/csrc/analog_update.cu",
             replaces="src/repro/kernels/analog_update.py:72",
             bound_by="bytes", library_ms=None,
             launches=launches + lm["in_place"], fcn_launches=launches,
             lm_launches=lm["in_place"], **kern_ip),
        dict(name="analog_update_hash", route="cuda",
             source="src/repro_torch/kernels/csrc/analog_update.cu",
             replaces="src/repro/kernels/analog_update.py:72",
             library_ms=None, **k1_hash),
        dict(name="hash_normal", route="cuda",
             source="src/repro_torch/kernels/csrc/fastrng.cu",
             replaces="none: jnp src/repro/kernels/fastrng.py:90, fused by "
                      "XLA",
             library_ms=None, **normal),
        dict(name="hash_device", route="cuda",
             source="src/repro_torch/kernels/csrc/fastrng.cu",
             replaces="none: jnp src/repro/core/device.py:140 (the hash "
                      "branch of sample_device), fused by XLA",
             library_ms=None, **drawn),
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
