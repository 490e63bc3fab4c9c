"""k1_roofline: K1's share of its roofline, in %. Layer: kernels
(``kernels/ops.py`` -> ``csrc/analog_update.cu``).

K1 (``analog_update_kernel``) is the pulse update of one analog array of a
tile in its hash-noise mode; a step runs it for every tile's P and W. The
least time of one update of an array of n elements is the larger of
  bytes / 3.35e12 B/s: the array read and written in the state dtype, the
      float32 increment, gamma and rho read (12 B), and one 8-byte seed;
  operations / 67e12 FLOP/s (float32 outside the tensor cores): 114 an
      element, the update's 30, the hash bits' 22 and the hash normal's 62,
      counted from the kernel's source;
(NVIDIA's H100 SXM data sheet, 700 W). The share is the sum of the least
times of the traced steps' updates over the device time of every launch
whose name holds ``analog_update_kernel``.
"""
import math

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
OPS = 114
SEED_BYTES = 8
STATE_BYTES = {"bfloat16": 2, "float32": 4}


def step_least_s(config) -> float:
    shapes = {leaf["path"]: leaf["shape"] for leaf in config["params"]}
    wb = STATE_BYTES[config["tiles"]["state_dtype"]]
    least = 0.0
    for group in config["tiles"]["groups"]:
        for path in group:
            n = math.prod(shapes[path])
            one = max((n * (2 * wb + 12) + SEED_BYTES) / HBM_BYTES_S,
                      n * OPS / FP32_OPS_S)
            least += 2 * one          # P and W
    return least


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    device_s = sum(t for name, t in tr["kernel_s"].items()
                   if "analog_update_kernel" in name)
    if device_s <= 0:
        return None
    return 100.0 * step_least_s(rec["config"]) * tr["steps"] / device_s
