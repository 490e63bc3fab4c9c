"""Parameter-tree paths and a minimal tree walker in JAX's leaf order.

Trees are nested dicts, lists and tuples of tensors, with ``None`` marking
an empty slot (the analog leaves of a digital parameter tree). JAX flattens
dicts in **sorted-key** order, torch's pytree in insertion order; tile
grouping, metric order and checkpoint names all follow JAX's order, so the
port walks trees with these helpers and never with ``torch.utils._pytree``.

Paths render as JAX's ``keystr(kp, simple=True, separator="/")`` does:
``{"fc1": {"w": x}}`` -> ``"fc1/w"``, list index 0 -> ``"0"``. A node
type of its own (``TileBank``) takes part through two methods:
``tree_children()`` gives its ``[(key, child)]`` in JAX's order and
``tree_rebuild(children)`` makes a new node from ``{key: child}``.

``TensorSpec`` is the leaf of an abstract tree (``jax.ShapeDtypeStruct``
with the device each leaf must land on).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of a tensor that is not allocated."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def ndim(self) -> int:
        return len(self.shape)


def npz_key(path: str) -> str:
    """Tree path -> npz member name ("tiles/g8x8_float32_nM/W" ->
    "tiles|g8x8_float32_nM|W"); checkpoint manifests persist these."""
    return path.replace("/", "|")


def npz_path(key: str) -> str:
    """Inverse of ``npz_key``."""
    return key.replace("|", "/")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return node.tree_children()


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or hasattr(x, "tree_children")


def flatten_with_path(tree, keep_none: bool = False) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's order. ``None`` slots are skipped, as JAX
    skips them, unless ``keep_none`` (JAX's ``is_leaf=lambda x: x is
    None``)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            if keep_none:
                out.append((prefix, None))
            return
        if _is_node(node):
            for k, v in _children(node):
                walk(v, f"{prefix}/{k}" if prefix else k)
            return
        out.append((prefix, node))

    walk(tree, "")
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; ``None`` slots of ``tree`` stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if hasattr(tree, "tree_children"):
        others = [dict(r.tree_children()) for r in rest]
        return tree.tree_rebuild({k: tree_map(fn, v, *(o[k] for o in others))
                                  for k, v in tree.tree_children()})
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, keep_none: bool = False,
                       prefix: str = ""):
    """``fn(path, leaf)`` over the leaves; ``None`` slots are passed to
    ``fn`` when ``keep_none``, else kept as ``None``."""
    if tree is None:
        return fn(prefix, None) if keep_none else None
    if _is_node(tree):
        def sub(k, v):
            return tree_map_with_path(fn, v, keep_none,
                                      f"{prefix}/{k}" if prefix else str(k))
        if isinstance(tree, dict):
            return type(tree)((k, sub(k, tree[k])) for k in tree)
        if isinstance(tree, (list, tuple)):
            return type(tree)(sub(i, v) for i, v in enumerate(tree))
        return tree.tree_rebuild({k: sub(k, v)
                                  for k, v in tree.tree_children()})
    return fn(prefix, tree)


def structure(tree):
    """Hashable tree structure (keys and ``None`` slots, not the leaves)."""
    if tree is None:
        return None
    if _is_node(tree):
        return (type(tree).__name__,
                tuple((k, structure(v)) for k, v in _children(tree)))
    return "*"
