"""The comparison that decides ``correct``: the program's first steps
against the plain reference's (``bench.reference.follow``).

Three numbers, each held to its own limit (``bench/limits/<cell>.json``):
  loss_gap    the largest relative gap of the two steps' losses;
  first_gap   the worst leaf's gap of the norm of what the optimizer holds
              after step 1 (digital leaves: the momentum, the clipped
              gradient; analog tiles: P, the gradient in pulses);
  change_gap  the worst leaf's gap of the norm of its change after the
              two steps (digital: the parameter; a tile: P, W, Q, Q~).
A leaf's gap is |program's norm - reference's norm| over the larger of the
reference's norm of that leaf and the median of the reference's norms over
the leaves of its kind (digital or analog), as some are all but zero.
Leaves whose reference gradient at step 1 is under a thousandth of the
median leaf's (a key's bias under softmax) move by round-off alone and are
not compared.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent
NAMES = ("loss_gap", "first_gap", "change_gap")


def compared_leaves(ref: Dict) -> List[str]:
    grads = ref["grad"]
    floor = 1e-3 * statistics.median(grads.values())
    return [p for p, g in grads.items() if g >= floor]


def _worst(prog: Dict, ref: Dict, leaves, analog):
    """(the worst leaf's gap, that leaf)."""
    worst, where = 0.0, ""
    for kind in (True, False):
        group = [p for p in leaves if (p in analog) == kind]
        if not group:
            continue
        mid = statistics.median(ref[p] for p in group)
        for p in group:
            den = max(ref[p], mid)
            gap = abs(prog[p] - ref[p]) / den if den > 0 else (
                0.0 if prog[p] == ref[p] else math.inf)
            if gap > worst or not where:
                worst, where = gap, p
    return worst, where


def gaps(prog: Dict, ref: Dict, analog, where: Dict = None
         ) -> Dict[str, float]:
    """{name: value} of the three numbers; ``analog``: the tile paths.
    ``where``, if given, gets the worst leaf of ``first_gap`` and
    ``change_gap``."""
    leaves = compared_leaves(ref)
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    out = {"loss_gap": loss}
    for name, kind in (("first_gap", "first"), ("change_gap", "change")):
        out[name], leaf = _worst(prog[kind], ref[kind], leaves, analog)
        if where is not None:
            where[name] = leaf
    return out


def limits(cell: str) -> Dict[str, float]:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def verdict(values: Dict[str, float], lim: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(values[n]) and values[n] <= lim[n]
               for n in NAMES)
