"""minicpm3-4b [dense] — MLA attention with depth-scaled residuals.

62L d_model=2560 40H d_ff=6400 vocab=73448, MLA (q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64) [hf:openbmb/MiniCPM3-4B].
residual_scale = 1.4 / sqrt(62) (scale_depth).
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv=40,
    head_dim=96,           # qk_nope + qk_rope (expanded form)
    d_ff=6400,
    vocab=73448,
    pattern=("mla",),
    n_periods=62,
    tail=(),
    q_lora=768,
    kv_lora=256,
    qk_nope=64,
    qk_rope=32,
    v_head_dim=64,
    residual_scale=1.4 / 62 ** 0.5,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm3-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=24,
    d_ff=128,
    vocab=512,
    pattern=("mla",),
    n_periods=3,
    tail=(),
    q_lora=32,
    kv_lora=16,
    qk_nope=16,
    qk_rope=8,
    v_head_dim=16,
    residual_scale=1.4 / 3 ** 0.5,
    attn_chunk=32,
    dtype=torch.float32,
)
