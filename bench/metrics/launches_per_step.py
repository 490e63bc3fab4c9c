"""launches_per_step: CUDA kernels a step in the traced window (copies and
fills not counted). Layer: host dispatch."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["steps"]
