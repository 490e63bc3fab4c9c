"""Top-level decoder-only language model.

Port of the training path of the JAX package's ``models/lm.py``:

  init(key, device) -> params          (abstract_params(device) allocates nothing)
  forward(params, tokens, frames) -> (logits, aux)
  loss(params, batch, rng) -> (loss, aux)   (next-token CE with z-loss)

The [vlm] frontend is the reference's stub: ``frames`` are precomputed
patch embeddings, fused additively with the token embeddings. Caches,
prefill, decode and paged serving come with serving (ROADMAP.md queue 1
item 14); the encoder of the enc-dec model with item 12b, so an enc-dec
config raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec, tree_map
from .blocks import apply_stack, check_ported, init_stack
from .common import dot, embed_init, rms_norm, softmax_cross_entropy, zeros


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, key, device="cuda") -> Dict:
        """Parameters from a host key (``prng.PRNGKey``), drawn on
        ``device`` as the JAX package draws them from the same key."""
        cfg = self.cfg
        check_ported(cfg)  # before the embedding's draw, not after it
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
        return params

    def abstract_params(self, device="cuda") -> Dict:
        """The parameter tree as ``TensorSpec`` leaves on ``device``: ``init``
        on the meta device, which allocates and draws nothing."""
        params = self.init(prng.PRNGKey(0), device="meta")
        return tree_map(lambda t: TensorSpec(t.shape, t.dtype, device), params)

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens, frames=None):
        cfg = self.cfg
        x = params["embed"][tokens.long()]
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

    # ---------------------------------------------------------------- forward
    def forward(self, params, tokens, frames=None):
        cfg = self.cfg
        x = self._embed(params, tokens, frames)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, aux, _ = apply_stack(params["stack"], x, cfg, "fwd",
                                positions=positions)
        return self._logits(params, x), aux

    def loss(self, params, batch, rng) -> Tuple[torch.Tensor, Dict]:
        logits, _ = self.forward(params, batch["tokens"], batch.get("frames"))
        return softmax_cross_entropy(logits, batch["labels"])
