"""Roofline analysis of one rank's traced step (no card needed).

Port of the JAX package's ``roofline/analysis.py``, with the same fields
and formulas, on the constants of the port's card, the NVIDIA H100 80GB
HBM3 (SXM, 700 W):

  compute    = flops / (chips * 989e12 FLOP/s, dense bf16 on the tensor cores)
  memory     = bytes / (chips * 3.35e12 B/s HBM3)
  collective = collective_bytes / (chips * 450e9 B/s, NVLink 4, one
               direction)

The flops, bytes and collective bytes are one rank's, priced from its op
trace by ``op_cost.analyze_trace``; whole-cluster totals are the rank's
times ``chips`` (every rank of the mesh runs the same step on its block).
The link rate is NVLink's within one node of 8 cards: a 256- or 512-rank
mesh spans nodes, whose links are slower, so the collective term is a
lower bound there.

MODEL_FLOPS = 6*N*D for training (2ND fwd + 4ND bwd) or 2*N_active*D for
serving; the ratio MODEL_FLOPS / flops exposes recompute, MoE dispatch
waste and masked-attention waste.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

PEAK_FLOPS = 989e12      # bf16 / card, dense (H100 SXM)
HBM_BW = 3.35e12         # B/s / card (HBM3)
LINK_BW = 450e9          # B/s / card, NVLink 4, one direction


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    model_flops: float
    bytes_per_device: float
    args_bytes_per_device: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-time / achievable step time (max of the three terms):
        how close the step is to the card's roofline."""
        t_min = self.model_flops / (self.chips * PEAK_FLOPS)
        t_star = max(self.t_compute, self.t_memory, self.t_collective)
        return t_min / max(t_star, 1e-30)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, cost,
            model_flops: float, peak_bytes: float = 0.0,
            args_bytes: float = 0.0) -> Roofline:
    """``cost``: one rank's ``op_cost.Cost``; whole-cluster totals are
    that times ``chips``. ``peak_bytes``/``args_bytes``: the rank's peak
    of live storage and its argument bytes."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops * chips,
        hlo_bytes=cost.bytes * chips,
        coll_bytes=cost.coll_bytes * chips,
        coll_breakdown={k: int(v * chips) for k, v in cost.coll.items()},
        model_flops=float(model_flops),
        bytes_per_device=float(peak_bytes),
        args_bytes_per_device=float(args_bytes),
    )


def model_flops_for(cfg, spec) -> float:
    """MODEL_FLOPS for a shape cell (6ND train / 2N_active D serve)."""
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n_active * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * spec.global_batch


def save_report(r: Roofline, path: str) -> None:
    with open(path, "w") as f:
        json.dump(r.to_json(), f, indent=2)
