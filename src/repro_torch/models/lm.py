"""Top-level language models: decoder-only and encoder-decoder.

Port of the JAX package's ``models/lm.py``:

  init(key, device) -> params          (abstract_params(device) allocates nothing)
  forward(params, tokens, frames) -> (logits, aux)
  loss(params, batch, rng) -> (loss, aux)   (next-token CE with z-loss,
                                             plus the MoE aux loss)

Under ``common.model_parallel`` (a trainer step on a model axis) the
embedding, the logits and the loss run on this rank's block of the
vocabulary when ``distributed.sharding.tp_layout`` splits it; ``forward``
then returns that block of the logits. An encoder-decoder's encoder runs
under the same axes (its attention and MLP split as the decoder's), and
each decoder layer's cross-attention reads its output.

Modality frontends are the reference's stubs: ``frames`` are precomputed
frame/patch embeddings; the VLM fuses them additively with the token
embeddings, the audio enc-dec feeds them to its encoder (a bidirectional
attention stack, ``_encoder_cfg``) whose output the decoder's
cross-attention reads.

The serve half, for every arch:

  init_cache(batch, seq_len, enc_len) / prefill / decode_step / serve_step
      the fixed-batch driver's dense cache (a ring buffer under a window;
      MLA latents; RG-LRU / SSD state; an encoder-decoder's cross K/V,
      built by ``prefill`` from the encoder's output);
  init_paged_cache / commit_prefill / prefill_commit_batch /
  decode_step_lanes / serve_step_lanes
      the continuous engine's cache: shared KV page pools, per-lane MLA
      latent rows and per-lane recurrent state (decoder-only models, as in
      the reference).

Every serve entry point runs without autograd and writes the cache it is
given in place, returning the same dict.

The fixed driver's entry points (``prefill``, ``decode_step``,
``serve_step``) also run as one rank of a mesh: under
``common.model_parallel`` and ``common.data_parallel``, on the weights
``distributed.sharding.compute_params`` gives the rank and its rows of the
batch, with ``shards`` (a ``distributed.sharding.CacheShards``) naming how
its cache blocks lie (``distributed.sharding.cache_shardings``). The
logits are then the rank's block of the vocabulary, and ``serve_step``'s
greedy token the whole vocabulary's (``common.vocab_greedy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import TensorSpec, tree_map
from ..trace import span
from .blocks import (apply_stack, commit_stack_prefill, init_paged_stack_cache,
                     init_stack, init_stack_cache)
from .common import (copy_to_model, dot, embed_init, rms_norm,
                     softmax_cross_entropy, split_width, vocab_greedy,
                     vocab_rows, zeros)


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
        # under a model axis ``embed`` may be this rank's block of the
        # vocabulary (``vocab_rows``: equal to the whole table's read)
        x = vocab_rows(params["embed"], tokens.long(), cfg.vocab)
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
        if split_width(head.shape[-1], cfg.vocab, "head"):
            # this rank's block of the vocabulary's logits (the reference's
            # hint at lm.py:70), read by ``softmax_cross_entropy(vocab=)``
            x = copy_to_model(x)
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
    def _hidden(self, params, tokens, frames=None):
        """(the last layer's output, the MoE aux loss) of ``tokens``."""
        cfg = self.cfg
        enc_out = self._encode(params, frames) if cfg.is_encdec else None
        x = self._embed(params, tokens, frames)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, aux, _ = apply_stack(params["stack"], x, cfg, "fwd",
                                positions=positions, enc_out=enc_out)
        return x, aux

    def forward(self, params, tokens, frames=None):
        x, aux = self._hidden(params, tokens, frames)
        return self._logits(params, x), aux

    def loss(self, params, batch, rng) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        x, aux_moe = self._hidden(params, batch["tokens"], batch.get("frames"))
        with span("model/head_loss"):
            logits = self._logits(params, x)
            loss, aux = softmax_cross_entropy(logits, batch["labels"],
                                              vocab=cfg.vocab)
        if cfg.n_experts:
            loss = loss + cfg.aux_loss_coef * aux_moe
            aux["moe_aux"] = aux_moe
        return loss, aux

    # ----------------------------------------------------------------- caches
    def init_cache(self, batch: int, seq_len: int, enc_len: int = 0,
                   abstract=False, device="cuda") -> Dict:
        cfg = self.cfg
        return init_stack_cache(cfg, batch, seq_len, enc_len=enc_len,
                                cross=cfg.is_encdec, abstract=abstract,
                                device=device)

    @torch.no_grad()
    def prefill(self, params, batch: Dict, cache: Dict, shards=None):
        """(logits (B,1,V) at the last position, cache filled in place)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        enc_out = (self._encode(params, batch.get("frames")) if cfg.is_encdec
                   else None)
        x = self._embed(params, tokens, batch.get("frames"))
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, _, cache = apply_stack(params["stack"], x, cfg, "prefill",
                                  positions=positions, caches=cache,
                                  enc_out=enc_out, shards=shards)
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params, token, cache: Dict, pos: int, shards=None):
        """token: (B,1) int32; pos: the position being written (an int)."""
        x = self._embed(params, token)
        x, _, cache = apply_stack(params["stack"], x, self.cfg, "decode",
                                  caches=cache, pos=pos, shards=shards)
        return self._logits(params, x), cache

    def serve_step(self, params, token, cache: Dict, pos: int, shards=None):
        """Greedy one-token serving step."""
        logits, cache = self.decode_step(params, token, cache, pos, shards)
        return self.greedy(logits), cache

    def greedy(self, logits):
        """The greedy token (B, 1) int32 of ``prefill``'s or
        ``decode_step``'s logits (a block of the vocabulary under a split
        head: the whole vocabulary's argmax)."""
        return vocab_greedy(logits, self.cfg.vocab)

    # ------------------------------------------------------- paged serving
    def init_paged_cache(self, lanes: int, num_pages: int, page_size: int,
                         max_len: int, abstract=False, device="cuda") -> Dict:
        """Decode cache of the continuous-batching serve engine: shared KV
        page pools for the attention layers (page 0 reserved as scratch),
        per-lane rows for MLA latents and recurrent state."""
        if self.cfg.is_encdec:
            raise NotImplementedError("paged serving supports decoder-only models")
        return init_paged_stack_cache(self.cfg, lanes, num_pages, page_size,
                                      max_len, abstract=abstract,
                                      device=device)

    @torch.no_grad()
    def commit_prefill(self, paged: Dict, dense: Dict, table_row, lane, *,
                       prompt_len: int, page_size: int) -> Dict:
        """Gather-free handoff from a batch-1 dense prefill cache into the
        paged cache, in place: prompt K/V scattered to the lane's pages
        (flat slot of logical j = table_row[j // page_size] * page_size +
        j % page_size), lane-dense leaves written at row ``lane``."""
        table_row = torch.as_tensor(table_row).long()
        idx = (table_row[:, None] * page_size
               + torch.arange(page_size, dtype=torch.int64,
                              device=table_row.device)[None, :]
               ).reshape(-1)[:prompt_len]
        return commit_stack_prefill(self.cfg, paged, dense, idx, lane)

    @torch.no_grad()
    def prefill_commit_batch(self, params, tokens, paged: Dict, tables, lanes,
                             starts, lengths, fresh):
        """Batched bucketed/chunked prefill straight into the paged cache.

        ``tokens`` (B,Cb) right-padded chunk tokens, ``tables`` (B,T)
        page-table rows, ``lanes`` (B,) decode lanes, ``starts`` (B,)
        absolute position of each row's first token, ``lengths`` (B,)
        valid run, ``fresh`` (B,) first-chunk flag (zeroes the prior
        recurrent state). One call per (Cb, B) bucket pair serves plain
        batched prefill (start=0), chunk continuation and prefix-shared
        tails. Returns (logits (B,1,V) at each row's last valid token,
        paged).
        """
        x = self._embed(params, tokens)
        Cb = tokens.shape[1]
        positions = (starts.long()[:, None]
                     + torch.arange(Cb, device=tokens.device)[None, :])
        x, _, paged = apply_stack(params["stack"], x, self.cfg, "chunk",
                                  positions=positions, caches=paged,
                                  table=tables, lengths=lengths,
                                  lane_idx=lanes, fresh=fresh)
        idx = (lengths.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        last = torch.gather(x, 1, idx)
        return self._logits(params, last), paged

    @torch.no_grad()
    def decode_step_lanes(self, params, token, cache: Dict, table, pos,
                          live=None):
        """Per-lane decode: token (B,1); table (B,T) page tables; pos (B,)
        per-lane write positions (free lanes point at the scratch page);
        ``live`` (B,) holds idle lanes' per-lane cache rows (MLA latents,
        rec/ssm state: layers with no scratch row)."""
        x = self._embed(params, token)
        x, _, cache = apply_stack(params["stack"], x, self.cfg, "decode",
                                  caches=cache, pos=pos, table=table,
                                  live=live)
        return self._logits(params, x), cache

    def serve_step_lanes(self, params, token, cache: Dict, table, pos,
                         live=None):
        from ..serving.sampling import sample_greedy

        logits, cache = self.decode_step_lanes(params, token, cache, table,
                                               pos, live)
        return sample_greedy(logits), cache


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
