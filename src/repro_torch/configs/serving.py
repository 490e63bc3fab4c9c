"""Per-architecture serving defaults for the continuous-batching engine.

Port of the JAX package's ``configs/serving.py`` (plain data, the same
table).

The training-side ``ModelConfig`` stays serving-agnostic; these defaults map
a model family onto engine knobs (decode lanes, KV page size, prefill
chunking).  Page size trades allocator granularity against gather width:
recurrent/SSM families carry O(1) state per lane, so their "pages" only
meter the few attention layers they mix in (or none at all — the allocator
still bounds admission).  ``prefill_chunk`` bounds the decode stall a single
long-prompt admission can inflict (0 = whole-prompt prefill); the engine
gates it off for families where chunk boundaries are not exactness-safe
(rec scans, misaligned SSM chunks).  ``prefix_share`` opts a family into
copy-on-write prompt-prefix page sharing (attention page-pool layers only).
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeDefaults:
    lanes: int = 8
    page_size: int = 16
    prefill_chunk: int = 0
    prefix_share: bool = False


_FAMILY_DEFAULTS = {
    "dense": ServeDefaults(lanes=8, page_size=16, prefill_chunk=64),
    "moe": ServeDefaults(lanes=4, page_size=16, prefill_chunk=64),
    # hybrid includes rec layers -> the engine disables chunking anyway
    "hybrid": ServeDefaults(lanes=8, page_size=16),
    "ssm": ServeDefaults(lanes=16, page_size=32),
    "audio": ServeDefaults(lanes=4, page_size=16),
    "vlm": ServeDefaults(lanes=8, page_size=16, prefill_chunk=64),
}


def serve_defaults(cfg: ModelConfig) -> ServeDefaults:
    return _FAMILY_DEFAULTS.get(cfg.family, ServeDefaults())
