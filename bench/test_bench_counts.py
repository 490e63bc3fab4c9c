"""The benchmark's frozen counts and its trace reduction.

The model FLOPs that ``mfu`` divides, K1's and ``hash_device``'s least
times at the Qwen2-0.5B MLP stack (24, 896, 4864) worked out by hand, and
the metric readers on a synthetic profiler record: overlapping kernels are
counted once in the device's busy time.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import run, trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def _counts(name):
    return run.load(BENCH / "counts" / f"{name}.py")


def _metric(name):
    return run.load(BENCH / "metrics" / f"{name}.py")


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


B16S1024 = {"batch": 16, "seq": 1024}
B4S4096 = {"batch": 4, "seq": 4096}


def test_qwen2_model_flops():
    c = _counts("qwen2-0.5b")
    assert c.MATMUL_PARAMS == 493_961_216            # 493.96 M
    dense = 6 * 493_961_216 * 16384                  # 48.557 TFLOP
    attn_1k = 12 * 24 * 16384 * 14 * 64 * 512        # 2.164 TFLOP
    assert c.step_flops(B16S1024) == pytest.approx(dense + attn_1k)
    assert c.step_flops(B4S4096) == pytest.approx(dense + 4 * attn_1k)
    assert c.step_flops(B16S1024) / 1e12 == pytest.approx(48.55 + 2.16,
                                                          abs=0.02)
    assert c.step_flops(B4S4096) / 1e12 == pytest.approx(48.55 + 8.65,
                                                         abs=0.02)


def test_mamba2_model_flops():
    c = _counts("mamba2-2.7b-l56")
    per_layer = 2560 * (2 * 5120 + 2 * 128 + 80) + 5120 * 2560  # 40.18 M
    assert c.MATMUL_PARAMS == 56 * per_layer + 50280 * 2560  # 2378.90 M
    ssd = 3 * (2 * 256 * 80 * 128 + 2 * 256 * 80 * 64 + 4 * 80 * 64 * 128
               + 2 * 80 * 64 * 128 / 256)
    want = 6 * c.MATMUL_PARAMS * 16384 + 56 * 16384 * ssd
    assert c.step_flops(B4S4096) == pytest.approx(want)
    assert 6 * c.MATMUL_PARAMS * 16384 / 1e12 == pytest.approx(233.86,
                                                               abs=0.01)
    assert 56 * 16384 * ssd / 1e12 == pytest.approx(28.87, abs=0.01)


def _stack_config(shape=(24, 896, 4864)):
    cfg = _config("qwen2-0.5b")
    cfg = dict(cfg, params=[{"path": "w", "shape": list(shape),
                             "dtype": "bfloat16", "init": "trunc"}])
    cfg["tiles"] = dict(cfg["tiles"], groups=[["w"]])
    return cfg


def test_k1_least_time_at_the_mlp_stack():
    n = 24 * 896 * 4864                                  # 104,595,456
    # bf16 w read and written (4 B), f32 dw, gamma, rho read (12 B): 16 B
    # an element and an 8-byte seed, for each of P and W
    one = (16 * n + 8) / 3.35e12                         # 499.56 us
    assert one == pytest.approx(499.56e-6, rel=1e-5)
    assert 114 * n / 67e12 < one                         # bytes bound it
    assert _metric("k1_roofline").step_least_s(_stack_config()) == \
        pytest.approx(2 * one)


def test_hash_device_least_time_at_the_mlp_stack():
    n = 24 * 896 * 4864
    byte_bound = (8 * n + 8) / 3.35e12                   # 249.78 us
    assert byte_bound == pytest.approx(249.78e-6, rel=1e-4)
    m = _metric("hash_device_roofline")
    tiles = _config("qwen2-0.5b")["tiles"]
    assert m.draw_ops(tiles["device_p"]) == 146          # gamma + target SP
    assert m.draw_ops(tiles["device_w"]) == 138          # gamma + rho
    assert 146 * n / 67e12 < byte_bound
    assert m.step_least_s(_stack_config()) == pytest.approx(2 * byte_bound)


def test_union_counts_overlapping_kernels_once():
    kernels = [("a", 0, 100), ("b", 50, 150), ("c", 300, 400),
               ("Memcpy HtoD", 390, 420)]
    cpu = [("bench/step", 0, 1000), ("aten::mm", 160, 290),
           ("bench/next_batch", 430, 1000)]
    rec = trace.reduce(kernels, cpu, window_s=1000e-9, steps=2)
    assert rec["busy_s"] == pytest.approx(270e-9)        # 0-150, 300-420
    assert rec["launches"] == 3
    assert rec["idle_gaps"][0] == ["bench/next_batch", pytest.approx(580e-9)]
    assert rec["idle_gaps"][1] == ["aten::mm", pytest.approx(150e-9)]
    full = {"trace": rec, "mix": B16S1024, "config": _stack_config(),
            "counts": _counts("qwen2-0.5b"), "data_wait_s": [1e-3, 3e-3],
            "steps": 3, "window_s": 0.5}
    assert _metric("device_idle_share").read(full) == pytest.approx(73.0)
    assert _metric("launches_per_step").read(full) == pytest.approx(1.5)
    assert _metric("data_wait_ms").read(full) == pytest.approx(2.0)
    # no K1 or hash_device launch in the trace: those readers find nothing
    assert _metric("k1_roofline").read(full) is None
    assert _metric("hash_device_roofline").read(full) is None
    # mfu reads the untraced window's steps and time, not the trace's
    assert _metric("mfu").read(full) == pytest.approx(
        100 * _counts("qwen2-0.5b").step_flops(B16S1024) * 3
        / (0.5 * 989e12))


def test_kernel_share_reads_the_named_launches():
    n = 24 * 896 * 4864
    kernels = [("void analog_update_kernel<bf16, float, true>(...)", 0,
                1_200_000), ("void hash_device_kernel<true, true>(...)",
                             1_200_000, 1_800_000)]
    rec = trace.reduce(kernels, [], window_s=2e-3, steps=1)
    full = {"trace": rec, "config": _stack_config()}
    k1 = 2 * (16 * n + 8) / 3.35e12
    assert _metric("k1_roofline").read(full) == pytest.approx(
        100 * k1 / 1.2e-3)
    hd = 2 * (8 * n + 8) / 3.35e12
    assert _metric("hash_device_roofline").read(full) == pytest.approx(
        100 * hd / 0.6e-3)
