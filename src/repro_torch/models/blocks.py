"""Layer blocks and the period stack (the full-sequence ``fwd`` mode).

Port of the JAX package's ``models/blocks.py``. A model stack = ``prefix``
layers (unrolled; e.g. DeepSeek's leading dense-FFN layer) + ``body`` =
cfg.pattern repeated cfg.n_periods times, its parameters stacked along a
leading ``n_periods`` axis per position in the period + ``tail`` layers
(unrolled; e.g. RecurrentGemma's trailing [rec, rec]). Every layer kind is
pre-norm -> sequence mixer (attention, MLA, RG-LRU or SSD) -> residual ->
pre-norm -> MLP or MoE -> residual; SSD blocks have no separate MLP.
Decoder stacks of enc-dec models carry a cross-attention sub-block.

Where the reference scans the periods (``lax.scan``), the port loops over
``leaf[i]`` of the stacked leaves, so a gradient reaches the stacked leaf
and the analog tiles hold the stacked arrays. ``cfg.remat`` wraps one
period in ``torch.utils.checkpoint`` as ``jax.checkpoint`` wraps
``period_fn``.

Only mode ``"fwd"`` is ported. The cache modes (``prefill``, ``chunk``,
``decode`` and the paged decode) and their cache and state makers come
with serving, and raise ``NotImplementedError`` naming it.
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
from . import recurrent as rec_mod
from .common import rms_norm, zeros

SERVING_MODES = ("prefill", "chunk", "decode")


def check_ported(mode: str) -> None:
    """Raise ``NotImplementedError`` for the modes serving brings."""
    if mode in SERVING_MODES:
        raise NotImplementedError(
            f"mode {mode!r} comes with serving (ROADMAP.md queue 1 item 14): "
            f"the {', '.join(SERVING_MODES)} modes and their caches and "
            f"recurrent states are not ported yet")
    if mode != "fwd":
        raise ValueError(mode)


# ---------------------------------------------------------------------------
# single-layer init/apply
# ---------------------------------------------------------------------------


def _layer_is_moe(cfg: ModelConfig, global_idx: int) -> bool:
    return bool(cfg.n_experts) and global_idx >= cfg.first_dense_layers


def init_layer(key, cfg: ModelConfig, kind: str, global_idx: int,
               cross: bool = False, device="cuda") -> Dict:
    ks = prng.split(key, 4)
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": zeros((d,), cfg.dtype, device)}
    if kind in ("attn", "attn_local"):
        p["attn"] = attn.init_attn(ks[0], cfg, device=device)
    elif kind == "mla":
        p["attn"] = attn.init_mla(ks[0], cfg, device=device)
    elif kind == "rec":
        p["mix"] = rec_mod.init_rglru(ks[0], cfg, device=device)
    elif kind == "ssm":
        p["mix"] = rec_mod.init_ssm(ks[0], cfg, device=device)
    else:
        raise ValueError(kind)
    if kind != "ssm":
        p["ln2"] = zeros((d,), cfg.dtype, device)
        if _layer_is_moe(cfg, global_idx):
            p["moe"] = moe_mod.init_moe(ks[1], cfg, device=device)
        else:
            p["mlp"] = moe_mod.init_mlp(ks[1], cfg, device=device)
    if cross:
        p["lnx"] = zeros((d,), cfg.dtype, device)
        p["cross"] = attn.init_attn(ks[2], cfg, cross=True, device=device)
    return p


def apply_layer(p: Dict, x, cfg: ModelConfig, kind: str, mode: str, *,
                positions=None, enc_out=None, causal: bool = True):
    """Returns (x_out, aux_loss, new_cache); mode ``"fwd"`` only."""
    check_ported(mode)
    rs = cfg.residual_scale
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        mix = attn.attn_forward(p["attn"], h, cfg, kind=kind,
                                positions=positions, causal=causal)
    elif kind == "mla":
        mix = attn.mla_forward(p["attn"], h, cfg, positions=positions,
                               causal=causal)
    elif kind == "rec":
        mix = rec_mod.rglru_forward(p["mix"], h, cfg)
    elif kind == "ssm":
        mix = rec_mod.ssm_forward(p["mix"], h, cfg)
    else:
        raise ValueError(kind)
    x = x + rs * mix

    if "cross" in p:
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + rs * attn.cross_forward(p["cross"], hx, enc_out, cfg)

    if kind != "ssm":
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            ff, aux = moe_mod.moe_forward(p["moe"], h2, cfg)
        else:
            ff = moe_mod.mlp_forward(p["mlp"], h2, cfg)
        x = x + rs * ff
    return x, aux, None


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
                positions=None, enc_out=None, causal: bool = True):
    """Returns (x, aux_total, new_caches); mode ``"fwd"`` only."""
    check_ported(mode)
    prefix, period, tail, n_periods = stack_structure(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layer(p, x, kind):
        return apply_layer(p, x, cfg, kind, mode, positions=positions,
                           enc_out=enc_out, causal=causal)

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
