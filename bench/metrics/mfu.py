"""mfu: the train step's model FLOPs (``bench/counts/<config>.py``) times
the window's steps over the window's host time times the H100's dense bf16
peak, 989e12 FLOP/s (NVIDIA's data sheet, SXM, 700 W), in %: the same
window as ``train_tokens_per_s``, untraced. Layer: train step."""

PEAK_BF16 = 989e12


def read(rec):
    if not rec["steps"] or rec["window_s"] <= 0:
        return None
    flops = rec["counts"].step_flops(rec["mix"])
    return 100.0 * flops * rec["steps"] / (rec["window_s"] * PEAK_BF16)
