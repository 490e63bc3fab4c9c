"""hash_device_roofline: the device draw's share of its roofline, in %.
Layer: kernels (``kernels/ops.py`` -> ``csrc/fastrng.cu``).

``hash_device_kernel`` writes a tile's float32 gamma and rho from its seed;
a step draws each tile's two devices (P's and W's). The least time of one
draw of n elements is the larger of
  bytes / 3.35e12 B/s: gamma and rho written (8 B an element) and one
      8-byte seed read;
  operations / 67e12 FLOP/s: a normal of the hash is 62 operations; gamma
      = exp(sigma_d2d n) adds 1 + 8 (the exponential) + 2 (its bounds) to
      its normal, rho from a normal adds 1 + 2 (its clip), rho from a
      target symmetric point adds 11 (counted from the kernel's source);
(NVIDIA's H100 SXM data sheet, 700 W). The share is the sum of the least
times of the traced steps' draws over the device time of every launch
whose name holds ``hash_device_kernel``.
"""
import math

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
NORMAL_OPS = 62
SEED_BYTES = 8


def draw_ops(dev) -> int:
    ops = NORMAL_OPS + 11 if dev["sigma_d2d"] > 0 else 0
    target = dev["ref_mean"] != 0.0 or dev["ref_std"] != 0.0
    return ops + NORMAL_OPS + (11 if target else 3)


def step_least_s(config) -> float:
    shapes = {leaf["path"]: leaf["shape"] for leaf in config["params"]}
    tiles = config["tiles"]
    ops = [draw_ops(tiles["device_p"]), draw_ops(tiles["device_w"])]
    least = 0.0
    for group in tiles["groups"]:
        for path in group:
            n = math.prod(shapes[path])
            for o in ops:
                least += max((8 * n + SEED_BYTES) / HBM_BYTES_S,
                             n * o / FP32_OPS_S)
    return least


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    device_s = sum(t for name, t in tr["kernel_s"].items()
                   if "hash_device_kernel" in name)
    if device_s <= 0:
        return None
    return 100.0 * step_least_s(rec["config"]) * tr["steps"] / device_s
