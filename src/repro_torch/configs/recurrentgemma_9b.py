"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

38L d_model=4096 16H (GQA kv=1, MQA) head_dim=256 d_ff=12288 vocab=256000
[arXiv:2402.19427]. Pattern: [rec, rec, attn_local] x 12 + [rec, rec] tail;
local window 2048; GeGLU; gemma-style sqrt(d) embedding scaling.
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    pattern=("rec", "rec", "attn_local"),
    n_periods=12,
    tail=("rec", "rec"),
    window=2048,
    d_rnn=4096,
    conv_k=4,
    activation="gelu",
    glu=True,
    embed_scale=True,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=2,
    n_kv=1,
    head_dim=32,
    d_ff=128,
    vocab=512,
    pattern=("rec", "rec", "attn_local"),
    n_periods=1,
    tail=("rec", "rec"),
    window=16,
    d_rnn=64,
    conv_k=4,
    activation="gelu",
    glu=True,
    embed_scale=True,
    attn_chunk=32,
    dtype=torch.float32,
)
