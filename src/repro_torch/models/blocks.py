"""Layer blocks and the period stack (the full-sequence ``fwd`` mode).

Port of the JAX package's ``models/blocks.py`` for the dense-attention
layer kinds. A model stack = ``prefix`` layers (unrolled) + ``body`` =
cfg.pattern repeated cfg.n_periods times, its parameters stacked along a
leading ``n_periods`` axis per position in the period + ``tail`` layers
(unrolled). Every layer is pre-norm -> attention -> residual -> pre-norm
-> MLP -> residual.

Where the reference scans the periods (``lax.scan``), the port loops over
``leaf[i]`` of the stacked leaves, so a gradient reaches the stacked leaf
and the analog tiles hold the stacked 3-D arrays. ``cfg.remat`` wraps one
period in ``torch.utils.checkpoint`` as ``jax.checkpoint`` wraps
``period_fn``.

Layer kinds and blocks that are not ported yet raise
``NotImplementedError`` naming the ROADMAP item that brings them; so do
the cache modes (prefill, decode, paged), which come with serving.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..configs.base import ModelConfig
from ..core.paths import tree_map
from . import attention as attn
from . import moe as moe_mod
from .common import rms_norm, zeros

_NOT_PORTED = {
    "moe": "MoE (ROADMAP.md queue 1 item 12b)",
    "mla": "MLA (ROADMAP.md queue 1 item 12b)",
    "rec": "the RG-LRU block (ROADMAP.md queue 1 item 12b)",
    "ssm": "the Mamba-2 SSD block (ROADMAP.md queue 1 item 12b)",
    "cross": "cross-attention and the encoder (ROADMAP.md queue 1 item 12b)",
}


def _not_ported(what: str):
    return NotImplementedError(f"{_NOT_PORTED[what]} is not ported yet")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` if ``cfg`` needs a block the port does
    not have yet."""
    for kind in cfg.layer_kinds:
        if kind not in ("attn", "attn_local"):
            raise _not_ported(kind)
    if cfg.n_experts:
        raise _not_ported("moe")
    if cfg.is_encdec:
        raise _not_ported("cross")


# ---------------------------------------------------------------------------
# single-layer init/apply
# ---------------------------------------------------------------------------


def init_layer(key, cfg: ModelConfig, kind: str, global_idx: int,
               cross: bool = False, device="cuda") -> Dict:
    ks = prng.split(key, 4)
    d = cfg.d_model
    if kind not in ("attn", "attn_local"):
        raise _not_ported(kind)
    if cfg.n_experts and global_idx >= cfg.first_dense_layers:
        raise _not_ported("moe")
    if cross:
        raise _not_ported("cross")
    return {"ln1": zeros((d,), cfg.dtype, device),
            "attn": attn.init_attn(ks[0], cfg, device=device),
            "ln2": zeros((d,), cfg.dtype, device),
            "mlp": moe_mod.init_mlp(ks[1], cfg, device=device)}


def apply_layer(p: Dict, x, cfg: ModelConfig, kind: str, mode: str, *,
                positions=None, causal: bool = True):
    """Returns (x_out, aux_loss, new_cache); mode ``"fwd"`` only."""
    if mode != "fwd":
        raise NotImplementedError(
            f"mode {mode!r} comes with serving (ROADMAP.md queue 1 item 14)")
    if kind not in ("attn", "attn_local"):
        raise _not_ported(kind)
    rs = cfg.residual_scale
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix = attn.attn_forward(p["attn"], h, cfg, kind=kind, positions=positions,
                            causal=causal)
    x = x + rs * mix
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + rs * moe_mod.mlp_forward(p["mlp"], h2, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), None


# ---------------------------------------------------------------------------
# stack machinery: prefix (unrolled) + body (periods) + tail
# ---------------------------------------------------------------------------


def stack_structure(cfg: ModelConfig) -> Tuple[List[str], List[str], List[str], int]:
    kinds = list(cfg.layer_kinds)
    nprefix = cfg.first_dense_layers
    prefix = kinds[:nprefix]
    rest = kinds[nprefix:]
    period = list(cfg.pattern)
    tail = list(cfg.tail)
    # how many full periods fit in `rest` before the tail
    body_len = len(rest) - len(tail)
    assert body_len % len(period) == 0, (cfg.name, body_len, period)
    n_periods = body_len // len(period)
    return prefix, period, tail, n_periods


def _stack(layers):
    return tree_map(lambda *ls: torch.stack(ls), *layers)


def init_stack(key, cfg: ModelConfig, cross: bool = False, device="cuda") -> Dict:
    """Parameters of the stack. The body's leaves of position j in the
    period stack the ``n_periods`` layers drawn from ``split(fold_in(key,
    kidx), n_periods)``, as the reference's vmapped init draws them."""
    check_ported(cfg)
    prefix, period, tail, n_periods = stack_structure(cfg)
    params: Dict[str, Any] = {"prefix": {}, "body": {}, "tail": {}}
    kidx = 0

    def nk():
        nonlocal kidx
        kidx += 1
        return prng.fold_in(key, kidx)

    for i, kind in enumerate(prefix):
        params["prefix"][f"l{i}"] = init_layer(nk(), cfg, kind, i, cross, device)
    for j, kind in enumerate(period):
        if n_periods == 0:
            continue
        keys = prng.split(nk(), n_periods)
        gidx = len(prefix) + j
        params["body"][f"p{j}"] = _stack(
            [init_layer(keys[i], cfg, kind, gidx, cross, device)
             for i in range(n_periods)])
    for i, kind in enumerate(tail):
        gidx = len(prefix) + n_periods * len(period) + i
        params["tail"][f"l{i}"] = init_layer(nk(), cfg, kind, gidx, cross, device)
    return params


def apply_stack(params: Dict, x, cfg: ModelConfig, mode: str, *,
                positions=None, causal: bool = True):
    """Returns (x, aux_total, new_caches); mode ``"fwd"`` only."""
    check_ported(cfg)
    prefix, period, tail, n_periods = stack_structure(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layer(p, x, kind):
        return apply_layer(p, x, cfg, kind, mode, positions=positions,
                           causal=causal)

    for i, kind in enumerate(prefix):
        x, aux, _ = run_layer(params["prefix"][f"l{i}"], x, kind)
        aux_total = aux_total + aux

    if n_periods > 0:
        body = [params["body"][f"p{j}"] for j in range(len(period))]

        def period_fn(h, aux_acc, i):
            for j, kind in enumerate(period):
                h, aux, _ = run_layer(tree_map(lambda l: l[i], body[j]), h,
                                      kind)
                aux_acc = aux_acc + aux
            return h, aux_acc

        remat = cfg.remat and mode == "fwd" and torch.is_grad_enabled()
        for i in range(n_periods):
            if remat:
                x, aux_total = checkpoint(period_fn, x, aux_total, i,
                                          use_reentrant=False)
            else:
                x, aux_total = period_fn(x, aux_total, i)

    for i, kind in enumerate(tail):
        x, aux, _ = run_layer(params["tail"][f"l{i}"], x, kind)
        aux_total = aux_total + aux
    return x, aux_total, None
