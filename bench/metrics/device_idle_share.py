"""device_idle_share: the share of the traced window in which no operation
ran on the device, 1 - (union of the device intervals) / window, in %.
Layer: device."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
