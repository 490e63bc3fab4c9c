"""Sampling and feed building shared by every serve driver.

Port of the JAX package's ``serving/sampling.py``. Greedy sampling is
``torch.argmax`` over the last position, which takes the first maximal
index as ``jnp.argmax`` does. Temperature / top-k sampling draws
``argmax(gumbel + logits)`` per lane from the lane's own threefry key
(``repro_torch.prng.categorical``), bit-compatible with
``jax.random.categorical`` up to the few-ULP gap of the two ``log`` calls
inside the Gumbel draw (a token can differ only at a near-tie).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from ..configs.base import ModelConfig
from ..kernels.ref import div


def sample_greedy(logits) -> torch.Tensor:
    """Greedy next token from (B, S, V) logits: argmax over the vocabulary
    at the last position, shaped (B, 1) int32 for the decode step."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def sample_topk(logits, temperature: float, k: int, key) -> torch.Tensor:
    """Temperature + top-k next token from (B, S, V) logits at the last
    position, shaped (B, 1) int32.

    ``key`` is a batch of per-lane keys (B, 2) (each lane draws from its
    own request-seeded stream). ``k`` = 0 disables the top-k filter (pure
    temperature sampling); ``temperature`` <= 0 falls back to greedy.
    """
    last = logits[:, -1].to(torch.float32)                            # (B,V)
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    # a true division, as jnp divides (torch's tensor / float multiplies by
    # the reciprocal on the card)
    scaled = div(last, float(np.float32(temperature)))
    if 0 < k < last.shape[-1]:
        kth = torch.topk(scaled, k, dim=-1).values[:, -1:]             # (B,1)
        scaled = torch.where(scaled < kth,
                             torch.full((), -np.inf, dtype=scaled.dtype,
                                        device=scaled.device), scaled)
    tok = prng.categorical(key, scaled)
    return tok.to(torch.int32)[:, None]


def lane_keys(seeds, pos) -> torch.Tensor:
    """Per-lane keys from per-request ``seeds`` (B,) and the lane's current
    ``pos`` (B,): the position folded into the seeded stream,
    ``fold_in(fold_in(PRNGKey(0), seed), pos)``, so every sampled token gets
    a fresh, replayable key. On the device of ``seeds``."""
    seeds = torch.as_tensor(seeds)
    root = prng.PRNGKey(0).to(seeds.device)
    return prng.fold_in(prng.fold_in(root, seeds), torch.as_tensor(pos))


class FeedBuilder:
    """Builds the prefill feed for a token batch on ``device``, caching the
    zero frames buffer per (batch, seq) shape instead of reallocating it
    per call."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._frames: Dict[Tuple[int, int], torch.Tensor] = {}

    def __call__(self, tokens) -> Dict[str, torch.Tensor]:
        tokens = torch.as_tensor(tokens).to(self.device, torch.int32)
        feed = {"tokens": tokens}
        if self.cfg.frontend:
            key = tuple(tokens.shape[:2])
            if key not in self._frames:
                self._frames[key] = torch.zeros(
                    key + (self.cfg.d_model,), dtype=self.cfg.dtype,
                    device=self.device)
            feed["frames"] = self._frames[key]
        return feed
