"""Deterministic synthetic datasets, numpy only.

A copy of the JAX package's ``data/synthetic.py`` (the port imports nothing
of that package), the same bytes from the same seeds:

* ``BigramLM``: token streams from a fixed random bigram table (top-8
  successors per token), deterministic in (seed, step), so host h of H can
  slice its rows of the same global batch;
* ``procedural_images`` / ``ImageDataset``: the MNIST stand-in, per-class
  smooth prototypes + structured noise + random +-1 px shifts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class BigramLM:
    vocab: int
    seed: int = 0
    concentration: float = 0.3  # lower -> peakier transitions (more learnable)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        logits = rng.gumbel(size=(self.vocab, self.vocab)) / self.concentration
        top = np.argsort(-logits, axis=1)[:, :8]
        self._succ = top.astype(np.int32)

    def batch(self, step: int, batch: int, seq_len: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        choices = rng.integers(0, 8, size=(batch, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def procedural_images(n: int, *, n_classes: int = 10, size: int = 28,
                      channels: int = 1, seed: int = 0, noise: float = 0.2,
                      sample_seed: int = None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n,size,size,channels) f32 in [0,1], y (n,) i32).
    ``seed`` fixes the class prototypes; ``sample_seed`` (default: seed)
    drives the per-sample noise/shift draws."""
    rng = np.random.default_rng(seed)
    protos = np.zeros((n_classes, size, size, channels), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(n_classes):
        for _ in range(5):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.08, 0.25, 2)
            amp = rng.uniform(0.6, 1.0)
            blob = amp * np.exp(-(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2))
            ch = rng.integers(0, channels)
            protos[c, :, :, ch] += blob
    protos /= protos.max(axis=(1, 2, 3), keepdims=True) + 1e-6

    rng = np.random.default_rng(seed if sample_seed is None else sample_seed)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y].copy()
    sh = rng.integers(-1, 2, size=(n, 2))
    for i in range(n):
        x[i] = np.roll(x[i], sh[i], axis=(0, 1))
    x += noise * rng.standard_normal(x.shape).astype(np.float32)
    return np.clip(x, 0.0, 1.0), y


@dataclasses.dataclass
class ImageDataset:
    """Epoch-shuffled minibatch iterator over a procedural image set."""

    n_train: int = 8192
    n_test: int = 2048
    n_classes: int = 10
    size: int = 28
    channels: int = 1
    seed: int = 0

    def __post_init__(self):
        self.x_train, self.y_train = procedural_images(
            self.n_train, n_classes=self.n_classes, size=self.size,
            channels=self.channels, seed=self.seed, sample_seed=self.seed + 1000)
        self.x_test, self.y_test = procedural_images(
            self.n_test, n_classes=self.n_classes, size=self.size,
            channels=self.channels, seed=self.seed, sample_seed=self.seed + 2000)

    def epoch(self, epoch_idx: int, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(self.n_train)
        for i in range(0, self.n_train - batch + 1, batch):
            sel = order[i: i + batch]
            yield {"x": self.x_train[sel], "y": self.y_train[sel]}

    def test_batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(0, self.n_test - batch + 1, batch):
            yield {"x": self.x_test[i: i + batch], "y": self.y_test[i: i + batch]}
