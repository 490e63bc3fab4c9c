"""qwen3-14b [dense] — GQA kv=8 with per-head qk-norm, no QKV bias.

40L d_model=5120 40H (kv=8) head_dim=128 d_ff=17408 vocab=151936
[hf:Qwen/Qwen3-8B family].
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    pattern=("attn",),
    n_periods=40,
    tail=(),
    qk_norm=True,
    qkv_bias=False,
    rope_base=1000000.0,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("attn",),
    n_periods=2,
    tail=(),
    qk_norm=True,
    qkv_bias=False,
    attn_chunk=32,
    dtype=torch.float32,
)
