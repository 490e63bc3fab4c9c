"""Global Drift Compensation (GDC) over effective analog weights.

Port of the JAX package's ``lifetime/gdc.py``. GDC estimates the global
drift scale of a matrix as hardware does, by pushing a fixed positive
reference input through the array and comparing column current sums with
the values recorded at programming time:

  sig(W)  = sum_j | sum_i x_i W_ij |
  alpha   = sig(W_t0) / sig(W_t)              (per weight matrix)
  W_gdc   = alpha * W_t

The reference input (``GDC_CHUNKS``, ``SALT_REF``, ``_REF_SEED``) is part
of the on-disk format: a manifest's ``gdc_signatures`` compare only against
the same x. Within the port a checkpoint restored at t0 reproduces every
signature bit for bit (the same code on the same device), so ``alpha ==
1.0`` and ``alpha * W`` is an exact no-op. Across the two packages the
products sum in other orders: ``alpha`` is 1 within a few ULP.

The product runs in float32 as an elementwise multiply and a column sum
over ``GDC_CHUNKS`` static row blocks, in the reference's block order, so
it never goes through TF32 and repeats bit for bit.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from ..core.paths import flatten_with_path, tree_map_with_path
from ..kernels import fastrng

GDC_CHUNKS = 4        # static row-block count of the signature
SALT_REF = 41         # fastrng salt of the fixed reference input
_REF_SEED = (0x9E3779B9, 0x85EBCA6B)


def reference_input(n: int, device="cuda") -> torch.Tensor:
    """Fixed positive reference vector in [0.5, 1) of length ``n``."""
    seed = torch.tensor(_REF_SEED, dtype=torch.int64)
    return 0.5 + 0.5 * fastrng.hash_uniform(seed, (n,), SALT_REF, device)


def weight_signature(w: torch.Tensor, chunks: int = GDC_CHUNKS) -> torch.Tensor:
    """Columnwise current-sum signature of one weight array (f32 0-d).

    ``w`` is read as a (rows, cols) matrix (leading axes flattened into
    rows; a 1-D array as one column). With ``chunks > 1`` the column
    currents accumulate over ``chunks`` row blocks of ``ceil(rows /
    chunks)`` rows (the reference pads the last block with zero rows,
    which add nothing)."""
    w2 = w.reshape(-1, w.shape[-1]) if w.ndim > 1 else w.reshape(-1, 1)
    w2 = w2.to(torch.float32)
    rows = w2.shape[0]
    x = reference_input(rows, w.device)
    if chunks <= 1 or rows < 2 * chunks:
        return torch.sum(torch.abs(torch.sum(x[:, None] * w2, dim=0)))
    step = -(-rows // chunks)
    cols = torch.zeros(w2.shape[1], dtype=torch.float32, device=w.device)
    for i in range(chunks):
        blk = slice(i * step, (i + 1) * step)
        cols = cols + torch.sum(x[blk, None] * w2[blk], dim=0)
    return torch.sum(torch.abs(cols))


def signature_tree(params, paths: Iterable[str],
                   chunks: int = GDC_CHUNKS) -> Dict[str, torch.Tensor]:
    """{path: signature} over the named leaves of ``params``."""
    want = set(paths)
    out = {p: weight_signature(leaf, chunks)
           for p, leaf in flatten_with_path(params) if p in want}
    missing = want - set(out)
    if missing:
        raise KeyError(f"signature paths absent from params: {sorted(missing)}")
    return out


def drift_scale(sig0: float, sig_t: float) -> float:
    """Per-matrix GDC scale ``alpha = sig0 / sig_t`` (host float64; exactly
    1.0 when the signatures agree bit for bit)."""
    sig_t = float(sig_t)
    if sig_t <= 0.0:
        return 1.0
    return float(sig0) / sig_t


def correct_params(params, sig0: Dict[str, float],
                   chunks: int = GDC_CHUNKS) -> Tuple:
    """GDC on every leaf with a stored t0 signature: ``(corrected params,
    {path: alpha})``. ``alpha`` is cast to the leaf's dtype before the
    product, so ``alpha == 1.0`` leaves the leaf bit-equal."""
    sig_t = {p: float(v) for p, v in
             signature_tree(params, tuple(sorted(sig0)), chunks).items()}
    scales = {p: drift_scale(sig0[p], sig_t[p]) for p in sig0}

    def fix(p, leaf):
        a = scales.get(p)
        if leaf is None or a is None:
            return leaf
        return (leaf * torch.tensor(a, dtype=leaf.dtype,
                                    device=leaf.device)).to(leaf.dtype)
    return tree_map_with_path(fix, params, keep_none=True), scales


def correct_in_graph(params, sig0: Dict[str, float], chunks: int = GDC_CHUNKS):
    """GDC with the alphas kept on the device (no host round trip): the
    form a captured serve step runs."""
    sigs = signature_tree(params, tuple(sorted(sig0)), chunks)

    def fix(p, leaf):
        if leaf is None or p not in sigs:
            return leaf
        # a fill on the device, not a host tensor copied to it
        alpha = torch.full((), sig0[p], dtype=torch.float32,
                           device=leaf.device) / torch.clamp_min(sigs[p], 1e-30)
        return (leaf * alpha.to(leaf.dtype)).to(leaf.dtype)
    return tree_map_with_path(fix, params, keep_none=True)
