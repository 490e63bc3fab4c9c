"""The weights and the key of a run, made from ``--seed``.

One ``torch.Generator`` on the run's device per parameter leaf, seeded from
(seed, leaf index), draws the leaf in one call in float32 and rounds it to
the leaf's dtype. The draws follow the port's initialisation scheme, leaf
by leaf as the configuration file lists it (``params``: path, shape, dtype,
init):
  normal         N(0, 1) (the embedding);
  trunc          N(0, 1 / fan_in) cut at two standard deviations, fan_in the
                 second-to-last dim (a stacked matrix's input width, a
                 convolution's width);
  zeros, ones    constants (norm weights, biases, the SSD skip);
  a_log          log(linspace(1, 16, H)) per layer (Mamba-2's A).
The same seed gives the same weights on the same device, so the reference
makes them again after the window instead of keeping a copy.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def key_words(seed: int):
    """The run's key as two uint32 words: a seed of 32 signed bits pads to
    (0, seed), a larger one splits into its high and low words."""
    seed = int(seed)
    hi = (seed >> 32) & 0xFFFFFFFF if not -2 ** 31 <= seed < 2 ** 31 else 0
    return hi, seed & 0xFFFFFFFF


def _generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & ((1 << 40) - 1)) << 12) + index)
    return g


def make_leaf(leaf: Dict, index: int, seed: int, device) -> torch.Tensor:
    shape = tuple(leaf["shape"])
    dtype = DTYPES[leaf["dtype"]]
    kind = leaf["init"]
    f32 = torch.float32
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "a_log":
        layers, heads = shape
        a = torch.log(torch.linspace(1.0, 16.0, heads, dtype=f32,
                                     device=device))
        return a.expand(layers, heads).to(dtype).clone()
    t = torch.empty(shape, dtype=f32, device=device)
    g = _generator(seed, index, device)
    if kind == "normal":
        t.normal_(generator=g)
    elif kind == "trunc":
        std = shape[-2] ** -0.5
        torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                    generator=g)
    else:
        raise ValueError(f"unknown init {kind!r} of {leaf['path']}")
    return t.to(dtype)


def make(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every parameter leaf of ``config``."""
    return {leaf["path"]: make_leaf(leaf, i, seed, device)
            for i, leaf in enumerate(config["params"])}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b": x} -> {"a": {"b": x}}: the parameter tree a model takes."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = t
    return tree
