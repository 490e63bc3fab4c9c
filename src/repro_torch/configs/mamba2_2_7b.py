"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).

64L d_model=2560, d_inner=5120 (expand 2), 80 SSD heads x P=64,
ssm_state N=128, conv k=4, vocab=50280 [arXiv:2405.21060].
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,           # unused (attention-free)
    n_kv=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    pattern=("ssm",),
    n_periods=64,
    tail=(),
    d_state=128,
    d_conv=4,
    expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_groups=1,
    tied_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=1,
    n_kv=1,
    head_dim=16,
    d_ff=0,
    vocab=512,
    pattern=("ssm",),
    n_periods=3,
    tail=(),
    d_state=16,
    d_conv=4,
    expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    ssm_groups=1,
    tied_embeddings=True,
    dtype=torch.float32,
)
