"""deepseek-v2-236b [moe] — MLA + 2 shared + 160 routed experts top-6.

60L d_model=5120 128H, MLA (q_lora=1536, kv_lora=512, qk_nope=128,
qk_rope=64, v_head=128), expert d_ff=1536, dense first layer d_ff=12288,
vocab=102400 [arXiv:2405.04434; hf].
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,
    head_dim=192,          # qk_nope + qk_rope (expanded form)
    d_ff=12288,            # dense FFN (first layer)
    vocab=102400,
    pattern=("mla",),
    n_periods=60,
    tail=(),
    q_lora=1536,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    n_shared=2,
    d_ff_expert=1536,
    first_dense_layers=1,
    capacity_factor=1.25,
    moe_group=2048,
    attn_chunk=1024,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-smoke",
    family="moe",
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
    n_experts=8,
    top_k=2,
    n_shared=1,
    d_ff_expert=32,
    first_dense_layers=1,
    capacity_factor=1.5,
    moe_group=64,
    attn_chunk=32,
    dtype=torch.float32,
)
