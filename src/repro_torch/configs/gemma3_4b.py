"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

34L d_model=2560 8H (kv=4) head_dim=256 d_ff=10240 vocab=262144
[hf:google/gemma-3 family]. Pattern: [local x5, global] x5 + [local x4]
tail; local window 1024; qk-norm; GeGLU; sqrt(d) embedding scaling.
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    pattern=("attn_local",) * 5 + ("attn",),
    n_periods=5,
    tail=("attn_local",) * 4,
    window=1024,
    qk_norm=True,
    rope_base=1000000.0,
    activation="gelu",
    glu=True,
    embed_scale=True,
    tied_embeddings=True,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=8,
    d_model=64,
    n_heads=2,
    n_kv=1,
    head_dim=32,
    d_ff=128,
    vocab=512,
    pattern=("attn_local",) * 5 + ("attn",),
    n_periods=1,
    tail=("attn_local",) * 2,
    window=16,
    qk_norm=True,
    activation="gelu",
    glu=True,
    embed_scale=True,
    tied_embeddings=True,
    attn_chunk=32,
    dtype=torch.float32,
)
