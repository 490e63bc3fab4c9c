"""The one generator of the benchmark's traffic, driven by a mix's data file.

A training mix (``bench/traffic/<mix>.json``) gives ``batch`` rows of
``seq`` tokens a step. Step k's rows are ``seq + 1`` token ids drawn
uniformly over the model's whole vocabulary by NumPy from (seed, k): the
tokens are the first ``seq``, the labels the last ``seq``. Every step's
rows differ, and the work of a step does not depend on the ids.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def train_batch(mix: Dict, vocab: int, seed: int, step: int) -> Dict:
    """{"tokens", "labels"}: int32 arrays (batch, seq) of step ``step``."""
    if mix["ids"] != "uniform":
        raise ValueError(f"unknown ids {mix['ids']!r}")
    seed = int(seed)
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(step)]))
    ids = rng.integers(0, vocab, size=(mix["batch"], mix["seq"] + 1),
                       dtype=np.int64).astype(np.int32)
    return {"tokens": np.ascontiguousarray(ids[:, :-1]),
            "labels": np.ascontiguousarray(ids[:, 1:])}
