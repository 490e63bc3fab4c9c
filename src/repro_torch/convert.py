"""Carry parameters and training state across from the JAX package.

The JAX package's arrays arrive as numpy arrays (``np.asarray`` of every
leaf), so this module needs neither JAX nor ``repro``. Both packages can
then step from the same state: ``train_state`` rebuilds a ``TrainState``
(TileBank classes, index, class_index, policies, opt, key, step), and
``params`` a parameter tree. uint32 arrays (keys, seeds) become int64
tensors, the port's uint32 form, and bfloat16 arrays bfloat16 tensors of
the same bits; keys, seeds and the step counter stay on the host, every
other tensor goes to ``device``. ``to_numpy`` goes back, for comparisons
(bfloat16 as float32, exactly).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.plan import TilePolicy, policy_from_json
from .core.tile import TileBank, TileState
from .core.trainer import HOST_LEAVES, TrainState


def tensor(x, device="cuda") -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: the same 16 bits
        bits = np.array(a, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params(tree, device="cuda"):
    """Nested dict/list/tuple of arrays -> the same tree of tensors
    (``None`` slots kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, params(v, device)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(params(v, device) for v in tree)
    return tensor(tree, device)


def tile_state(d: Dict[str, Any], device="cuda") -> TileState:
    return TileState(
        (k, None if v is None else
         params(v, "cpu" if k in HOST_LEAVES else device))
        for k, v in d.items())


def _policy(p):
    if p is None or isinstance(p, TilePolicy):
        return p
    return policy_from_json(p)


def tile_bank(classes: Dict[str, Dict], index, class_index, policies=None,
              device="cuda") -> TileBank:
    """Class-keyed stacks (leaves ``(C, n, *member)``) -> TileBank.
    ``policies``: {group: TilePolicy or its ``policy_to_json`` dict}."""
    return TileBank.from_classes(
        {c: tile_state(st, device) for c, st in classes.items()},
        index, class_index,
        {g: _policy(p) for g, p in (policies or {}).items()})


def train_state(state: Dict[str, Any], device="cuda") -> TrainState:
    """``state``: {"step", "key", "params", "opt", "tiles"} where "tiles" is
    {"classes", "index", "class_index", "policies"} (grouped engine) or
    {path: tile dict} (looped engine)."""
    tiles = state["tiles"]
    if isinstance(tiles, dict) and "classes" in tiles:
        tiles = tile_bank(tiles["classes"], tiles["index"],
                          tiles["class_index"], tiles.get("policies"), device)
    else:
        tiles = {p: tile_state(t, device) for p, t in tiles.items()}
    return TrainState(
        step=tensor(state["step"], "cpu").to(torch.int32),
        key=tensor(state["key"], "cpu"),
        params=params(state["params"], device),
        tiles=tiles,
        opt=params(state["opt"], device),
    )


def to_numpy(tree):
    """Tensors -> numpy arrays through any nesting; a TileBank -> its class
    dict."""
    if isinstance(tree, TileBank):
        return {c: to_numpy(st) for c, st in tree.classes.items()}
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        # numpy has no bfloat16: widen it, exactly, to float32
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
