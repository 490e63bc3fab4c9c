"""Top-level language models: decoder-only and encoder-decoder.

Port of the training path of the JAX package's ``models/lm.py``:

  init(key, device) -> params          (abstract_params(device) allocates nothing)
  forward(params, tokens, frames) -> (logits, aux)
  loss(params, batch, rng) -> (loss, aux)   (next-token CE with z-loss,
                                             plus the MoE aux loss)

Modality frontends are the reference's stubs: ``frames`` are precomputed
frame/patch embeddings; the VLM fuses them additively with the token
embeddings, the audio enc-dec feeds them to its encoder (a bidirectional
attention stack, ``_encoder_cfg``) whose output the decoder's
cross-attention reads. Caches, prefill, decode and paged serving come with
serving (ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec, tree_map
from .blocks import apply_stack, init_stack
from .common import (dot, embed_init, rms_norm, softmax_cross_entropy,
                     take_rows, zeros)


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, key, device="cuda") -> Dict:
        """Parameters from a host key (``prng.PRNGKey``), drawn on
        ``device`` as the JAX package draws them from the same key."""
        cfg = self.cfg
        ks = prng.split(key, 4)
        params: Dict[str, Any] = {
            "embed": embed_init(ks[0], (cfg.vocab, cfg.d_model), cfg.dtype,
                                device),
            "stack": init_stack(ks[1], cfg, cross=cfg.is_encdec, device=device),
            "ln_f": zeros((cfg.d_model,), cfg.dtype, device),
        }
        if not cfg.tied_embeddings:
            params["head"] = embed_init(ks[2], (cfg.d_model, cfg.vocab),
                                        cfg.dtype, device)
        if cfg.is_encdec:
            params["enc"] = {
                "stack": init_stack(ks[3], _encoder_cfg(cfg), cross=False,
                                    device=device),
                "ln_f": zeros((cfg.d_model,), cfg.dtype, device),
            }
        return params

    def abstract_params(self, device="cuda") -> Dict:
        """The parameter tree as ``TensorSpec`` leaves on ``device``: ``init``
        on the meta device, which allocates and draws nothing."""
        params = self.init(prng.PRNGKey(0), device="meta")
        return tree_map(lambda t: TensorSpec(t.shape, t.dtype, device), params)

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens, frames=None):
        cfg = self.cfg
        x = take_rows(params["embed"], tokens.long())
        if cfg.embed_scale:
            scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                            dtype=torch.float32))
            x = x * scale.to(device=x.device, dtype=x.dtype)
        if frames is not None and not cfg.is_encdec:
            x = x + frames.to(x.dtype)  # VLM stub: additive patch fusion
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        head = params["embed"].T if cfg.tied_embeddings else params["head"]
        return dot(x, head)

    def _encode(self, params, frames):
        cfg = self.cfg
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its "
                             f"encoder reads the batch's 'frames'")
        x = frames.to(cfg.dtype)
        pos = torch.arange(x.shape[1], device=x.device)[None]
        x, _, _ = apply_stack(params["enc"]["stack"], x, _encoder_cfg(cfg),
                              "fwd", positions=pos, causal=False)
        return rms_norm(x, params["enc"]["ln_f"], cfg.norm_eps)

    # ---------------------------------------------------------------- forward
    def forward(self, params, tokens, frames=None):
        cfg = self.cfg
        enc_out = self._encode(params, frames) if cfg.is_encdec else None
        x = self._embed(params, tokens, frames)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, aux, _ = apply_stack(params["stack"], x, cfg, "fwd",
                                positions=positions, enc_out=enc_out)
        return self._logits(params, x), aux

    def loss(self, params, batch, rng) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        logits, aux_moe = self.forward(params, batch["tokens"],
                                       batch.get("frames"))
        loss, aux = softmax_cross_entropy(logits, batch["labels"])
        if cfg.n_experts:
            loss = loss + cfg.aux_loss_coef * aux_moe
            aux["moe_aux"] = aux_moe
        return loss, aux


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """Encoder stack config: bidirectional full attention, n_enc_layers."""
    return dataclasses.replace(
        cfg,
        n_layers=cfg.n_enc_layers,
        pattern=("attn",),
        n_periods=cfg.n_enc_layers,
        tail=(),
        first_dense_layers=0,
        n_experts=0,
        n_enc_layers=0,
    )
