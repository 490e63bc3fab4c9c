"""seamless-m4t-large-v2 [audio] — encoder-decoder transformer backbone.

24L enc + 24L dec, d_model=1024 16H (kv=16) head_dim=64 d_ff=8192
vocab=256206 [arXiv:2308.11596; hf]. The speech/audio frontend is a STUB:
input_specs() provides precomputed frame embeddings (B, S, d) consumed
directly by the encoder. Decode shapes lower the decoder serve_step with
self- and cross-attention caches.
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    pattern=("attn",),
    n_periods=24,
    tail=(),
    n_enc_layers=24,
    frontend="audio",
    activation="gelu",
    glu=False,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("attn",),
    n_periods=2,
    tail=(),
    n_enc_layers=2,
    frontend="audio",
    activation="gelu",
    glu=False,
    attn_chunk=32,
    dtype=torch.float32,
)
