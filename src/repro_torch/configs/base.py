"""Model configuration schema shared by all 10 architectures.

Port of the JAX package's ``configs/base.py``; ``dtype`` is a
``torch.dtype``. Every architecture file in this package exports:
  CONFIG        — the exact full-size config
  SMOKE_CONFIG  — a reduced same-family config for CPU smoke tests
  (both are ``ModelConfig`` instances)

``input_specs(cfg, shape_name, device)`` builds ``TensorSpec`` stand-ins
for every model input of an (arch x shape) cell — no allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.paths import TensorSpec

# ---------------------------------------------------------------------------
# Layer kinds used in ``pattern``:
#   attn        — full causal self-attention + MLP
#   attn_local  — sliding-window causal self-attention + MLP
#   mla         — multi-head latent attention (DeepSeek-style) + MLP/MoE
#   rec         — RG-LRU recurrent block (Griffin) + MLP
#   ssm         — Mamba-2 SSD block (no separate MLP)
# ---------------------------------------------------------------------------

LAYER_KINDS = ("attn", "attn_local", "mla", "rec", "ssm")

# Parameter-path substrings that stay on the digital optimizer in every
# analog plan (the paper's setups keep embeddings / vocab heads / positional
# tables digital). Consumed by ``repro_torch.api.lm_plan``, which turns each
# into a leading ``re:`` DIGITAL rule.
DIGITAL_PATH_PATTERNS: Tuple[str, ...] = ("embed", "vocab", "lm_head", "pos")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | hybrid | ssm | audio | vlm
    # core dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    # layer pattern: `pattern` repeats `n_periods` times, then `tail`.
    # n_periods * len(pattern) + len(tail) == n_layers.
    pattern: Tuple[str, ...] = ("attn",)
    n_periods: int = 4
    tail: Tuple[str, ...] = ()
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    window: int = 0                  # sliding window for attn_local
    rope_base: float = 10000.0
    rope_type: str = "rope"          # rope | mrope
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_chunk: int = 1024           # KV chunk for memory-efficient attention
    attn_logit_softcap: float = 0.0
    # MLA (deepseek/minicpm)
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head_dim: int = 0
    mla_absorbed: bool = False   # latent-space attention (see §Perf)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0      # leading layers with dense FFN
    capacity_factor: float = 1.25
    moe_group: int = 2048            # GShard dispatch group size
    moe_impl: str = "einsum"         # einsum | ragged
    aux_loss_coef: float = 0.01
    # SSM (mamba2)
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # RG-LRU (griffin)
    d_rnn: int = 0                   # 0 -> d_model
    rglru_c: float = 8.0
    conv_k: int = 4
    # encoder-decoder (seamless)
    n_enc_layers: int = 0            # 0 -> decoder-only
    frontend: Optional[str] = None   # None | audio | vision (stubs)
    # misc
    activation: str = "silu"         # silu | gelu
    glu: bool = True
    tied_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling
    residual_scale: float = 1.0      # minicpm depth scaling
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # training
    remat: bool = True
    microbatch: int = 1              # gradient-accumulation microbatches

    def __post_init__(self):
        assert self.n_periods * len(self.pattern) + len(self.tail) == self.n_layers, (
            self.name, self.n_layers, self.pattern, self.n_periods, self.tail)
        for k in self.pattern + self.tail:
            assert k in LAYER_KINDS, k

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.pattern * self.n_periods + self.tail

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        return _count_params(self, active_only=True)


# ---------------------------------------------------------------------------
# Shapes (the four assigned input-shape cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True if the arch supports long_500k (not pure full attention)."""
    kinds = set(cfg.layer_kinds)
    if kinds & {"ssm", "rec"}:
        return True
    if "attn_local" in kinds and cfg.window > 0:
        # pure-SWA (mixtral) or mostly-local (gemma3) qualify
        return True
    return False


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(applicable, reason)."""
    if shape == "long_500k" and not sub_quadratic(cfg):
        return False, "pure full-attention arch; 500k decode cache excluded (DESIGN.md §5)"
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str,
                device="cuda") -> Dict[str, Any]:
    """TensorSpec stand-ins for the model inputs of one shape cell.

    train:   {tokens (B,S) i32, labels (B,S) i32 [, frames (B,S,d)]}
    prefill: {tokens (B,S) i32 [, frames]}
    decode:  {tokens (B,1) i32, pos () i32}  — cache specs come from the
             model's ``cache_specs`` (state, not input).
    """
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32

    def tok(shape):
        return TensorSpec(shape, i32, device)

    out: Dict[str, Any] = {}
    if spec.kind == "train":
        out["tokens"] = tok((B, S))
        out["labels"] = tok((B, S))
    elif spec.kind == "prefill":
        out["tokens"] = tok((B, S))
    else:  # decode
        out["tokens"] = tok((B, 1))
        out["pos"] = TensorSpec((), i32, device)

    if cfg.frontend is not None and spec.kind != "decode":
        # modality stub: precomputed frame/patch embeddings
        out["frames"] = TensorSpec((B, S, cfg.d_model), cfg.dtype, device)
    if cfg.is_encdec and spec.kind == "decode":
        # decoder steps attend to a precomputed encoder output
        out["enc_out"] = TensorSpec((B, min(S, 32768), cfg.d_model),
                                    cfg.dtype, device)
    return out


# ---------------------------------------------------------------------------
# parameter counting (roofline MODEL_FLOPS)
# ---------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    if kind == "mla":
        q = d * cfg.q_lora + cfg.q_lora * cfg.n_heads * (cfg.qk_nope + cfg.qk_rope)
        kv = d * (cfg.kv_lora + cfg.qk_rope)
        kv += cfg.kv_lora * cfg.n_heads * (cfg.qk_nope + cfg.v_head_dim)
        o = cfg.n_heads * cfg.v_head_dim * d
        return q + kv + o
    hd = cfg.head_dim
    return d * (cfg.n_heads * hd) * 2 + d * (cfg.n_kv * hd) * 2


def _mlp_params(cfg: ModelConfig, layer_idx: int) -> int:
    d = cfg.d_model
    if cfg.n_experts and layer_idx >= cfg.first_dense_layers:
        e_ff = cfg.d_ff_expert or cfg.d_ff
        n_mats = 3 if cfg.glu else 2
        routed = cfg.n_experts * n_mats * d * e_ff
        shared = cfg.n_shared * n_mats * d * e_ff
        router = d * cfg.n_experts
        return routed + shared + router
    n_mats = 3 if cfg.glu else 2
    return n_mats * d * cfg.d_ff


def _layer_params(cfg: ModelConfig, kind: str, layer_idx: int) -> int:
    d = cfg.d_model
    if kind == "ssm":
        din = cfg.d_inner
        zxbcdt = d * (2 * din + 2 * cfg.ssm_groups * cfg.d_state + cfg.ssm_heads)
        return zxbcdt + din * d + cfg.ssm_heads * 2 + din
    if kind == "rec":
        dr = cfg.rnn_width
        mix = d * dr * 2 + dr * d + 2 * dr * dr + cfg.conv_k * dr
        return mix + _mlp_params(cfg, layer_idx)
    return _attn_params(cfg, kind) + _mlp_params(cfg, layer_idx)


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab * cfg.d_model  # embeddings
    if not cfg.tied_embeddings:
        total += cfg.vocab * cfg.d_model
    kinds = cfg.layer_kinds
    for i, k in enumerate(kinds):
        p = _layer_params(cfg, k, i)
        if active_only and cfg.n_experts and k in ("attn", "attn_local", "mla") and i >= cfg.first_dense_layers:
            e_ff = cfg.d_ff_expert or cfg.d_ff
            n_mats = 3 if cfg.glu else 2
            inactive = (cfg.n_experts - cfg.top_k) * n_mats * cfg.d_model * e_ff
            p -= inactive
        total += p
    if cfg.is_encdec:
        # encoder layers (full attention, no causal) + cross-attn in decoder
        for i in range(cfg.n_enc_layers):
            total += _layer_params(cfg, "attn", i)
        total += cfg.n_layers * _attn_params(cfg, "attn")  # cross-attn
    return int(total)
