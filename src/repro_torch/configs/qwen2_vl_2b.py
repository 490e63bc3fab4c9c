"""qwen2-vl-2b [vlm] — M-RoPE text backbone; vision frontend stub.

28L d_model=1536 12H (kv=2) head_dim=128 d_ff=8960 vocab=151936
[arXiv:2409.12191; hf]. M-RoPE sections (t,h,w) = (16,24,24) over the
head_dim/2=64 rotary channels. input_specs() provides precomputed patch
embeddings fused additively with token embeddings (frontend STUB).
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    pattern=("attn",),
    n_periods=28,
    tail=(),
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    tied_embeddings=True,
    frontend="vision",
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=32,
    d_ff=128,
    vocab=512,
    pattern=("attn",),
    n_periods=2,
    tail=(),
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(4, 6, 6),
    tied_embeddings=True,
    frontend="vision",
    attn_chunk=32,
    dtype=torch.float32,
)
