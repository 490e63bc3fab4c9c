"""qwen2-0.5b [dense] — GQA kv=2 with QKV bias, tied embeddings.

24L d_model=896 14H (kv=2) head_dim=64 d_ff=4864 vocab=151936
[arXiv:2407.10671; hf].
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    head_dim=64,
    d_ff=4864,
    vocab=151936,
    pattern=("attn",),
    n_periods=24,
    tail=(),
    qkv_bias=True,
    tied_embeddings=True,
    rope_base=1000000.0,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-smoke",
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
    qkv_bias=True,
    tied_embeddings=True,
    attn_chunk=32,
    dtype=torch.float32,
)
