"""mixtral-8x7b [moe] — 8 experts top-2, GQA kv=8, sliding-window attention.

32L d_model=4096 32H (kv=8) head_dim=128 expert d_ff=14336 vocab=32000,
SWA window 4096 [arXiv:2401.04088; hf].
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    pattern=("attn_local",),
    n_periods=32,
    tail=(),
    window=4096,
    n_experts=8,
    top_k=2,
    d_ff_expert=14336,
    capacity_factor=1.25,
    moe_group=2048,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("attn_local",),
    n_periods=2,
    tail=(),
    window=16,
    n_experts=4,
    top_k=2,
    d_ff_expert=128,
    capacity_factor=1.5,
    moe_group=64,
    attn_chunk=32,
    dtype=torch.float32,
)
