"""Declarative structural contracts over the operation stream of a step.

Port of the JAX package's ``analysis/contracts.py``. The JAX module holds
XLA's optimized HLO text to a ``GraphContract``; the port has no compiled
graph, and its counterpart is the stream of ATen operations one eager
call of an entrypoint dispatches (``roofline.op_cost.OpTrace``). The rules
map one to one where they can:

* **no restacks** -- an ``aten.cat`` / ``aten.stack`` whose result has rank
  >= ``restack_rank`` (the reference's rank-N ``concatenate``): class
  stacks are updated in place of their layout, never rebuilt slice by
  slice.
* **donation applied** -- the count of state leaves whose storage the
  returned state keeps (``untyped_storage().data_ptr()``; identity on
  ``meta``), at least ``min_aliased``; and no ``copy_`` / ``clone`` /
  dtype-keeping ``_to_copy`` result larger than ``max_copy_bytes`` (a
  full copy of a pool means the write was not in place).
* **no host reads** -- a device-to-host read (``_local_scalar_dense``, a
  copy from a device tensor to the CPU) stalls the card; on a CPU run
  every scalar read counts. Host-to-device uploads are counted (calls,
  bytes) under the ceiling ``max_uploads``.
* **dtype allowlist** -- every record's dtypes inside the contract's list;
  ``float64`` / ``complex64`` / ``complex128`` never.
* **cost ceilings** -- collective bytes and memory bytes a call, priced by
  ``roofline.op_cost``.

The reference's trip-count rule has no counterpart: a trace is unrolled.

``check_trace`` is pure (records in, result out), so the unit tests feed it
synthetic records; building and tracing the real entrypoints lives in
``graph_contracts.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..roofline import op_cost
from ..roofline.op_common import DTYPE_BYTES, FORBIDDEN_DTYPES

DEFAULT_ALLOWED_DTYPES = frozenset(
    ("bool", "int8", "uint8", "int16", "int32", "uint32", "int64", "float16",
     "bfloat16", "float32"))

RESTACK_OPS = ("aten.cat.", "aten.stack.")
COPIES = ("aten.copy_.", "aten.clone.", "aten._to_copy.")


def _is_copy(rec) -> bool:
    """A copy of a buffer: ``copy_``, ``clone``, or a ``_to_copy`` that
    keeps the dtype (a cast computes a new value; it is not a copy)."""
    if not rec.name.startswith(COPIES) or not rec.outputs:
        return False
    if rec.name.startswith("aten._to_copy."):
        return rec.inputs[0].dtype == rec.outputs[0].dtype
    return True


@dataclasses.dataclass(frozen=True)
class GraphContract:
    """Structural invariants for one entrypoint's operation stream."""

    name: str
    description: str = ""
    # cat/stack results of rank >= restack_rank count as restacks (class
    # stacks are (C, n, *member): a restack of 2-D members is rank 4)
    restack_rank: int = 4
    max_restacks: int = 0
    # donation: >= min_aliased state leaves keep their storage, and no
    # single copy writes more than max_copy_bytes
    require_donation: bool = True
    min_aliased: int = 1
    max_copy_bytes: int = 1 << 62
    # host-to-device uploads a call may make (host reads always violate)
    max_uploads: int = 0
    allowed_dtypes: Tuple[str, ...] = tuple(sorted(DEFAULT_ALLOWED_DTYPES))
    max_collective_bytes: float = 0.0
    max_hbm_bytes: float = float("inf")

    def __post_init__(self):
        bad = set(self.allowed_dtypes) & FORBIDDEN_DTYPES
        if bad:
            raise ValueError(
                f"contract {self.name!r} allowlists forbidden dtypes {sorted(bad)}")
        unknown = set(self.allowed_dtypes) - set(DTYPE_BYTES)
        if unknown:
            raise ValueError(
                f"contract {self.name!r} allowlists unknown dtypes {sorted(unknown)}")

    def limits_json(self) -> Dict:
        """The loosenable knobs, for baseline drift detection."""
        return {
            "restack_rank": self.restack_rank,
            "max_restacks": self.max_restacks,
            "require_donation": self.require_donation,
            "min_aliased": self.min_aliased,
            "max_copy_bytes": self.max_copy_bytes,
            "max_uploads": self.max_uploads,
            "allowed_dtypes": sorted(self.allowed_dtypes),
            "max_collective_bytes": self.max_collective_bytes,
            "max_hbm_bytes": self.max_hbm_bytes,
        }


@dataclasses.dataclass
class ContractResult:
    name: str
    violations: List[Dict[str, str]] = dataclasses.field(default_factory=list)
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> Dict:
        return {"name": self.name, "ok": self.ok,
                "violations": list(self.violations), "stats": dict(self.stats)}


def check_trace(contract: GraphContract, trace, aliased: int = 0,
                check_hbm: bool = True) -> ContractResult:
    """Hold ``trace`` (an ``OpTrace``, or anything with its ``records``,
    ``flops`` and ``collectives``) to ``contract``; ``aliased`` is the
    count of state leaves the call kept in place. ``check_hbm=False``
    leaves out the memory ceiling (measured on the CPU; the card's stream
    differs in its copies)."""
    res = ContractResult(contract.name)
    restacks, host_ops = [], []
    copies_max = uploads = upload_bytes = 0
    dtypes_seen = set()
    for i, rec in enumerate(trace.records):
        dtypes_seen.update(rec.dtypes())
        if rec.name.startswith(RESTACK_OPS) and any(
                len(m.shape) >= contract.restack_rank for m in rec.outputs):
            restacks.append(f"#{i} {rec.short}")
        elif _is_copy(rec):
            copies_max = max(copies_max, rec.result_bytes())
        if rec.host_read:
            host_ops.append(f"#{i} {rec.short}")
        if rec.upload_bytes:
            uploads += 1
            upload_bytes += rec.upload_bytes

    cost = op_cost.analyze_trace(trace)

    def violate(rule: str, detail: str) -> None:
        res.violations.append({"rule": rule, "detail": detail})

    if len(restacks) > contract.max_restacks:
        violate("restack",
                f"{len(restacks)} cat/stack op(s) of rank >= "
                f"{contract.restack_rank} (contract allows "
                f"{contract.max_restacks}): {', '.join(restacks[:5])}")
    if contract.require_donation and aliased < contract.min_aliased:
        violate("donation",
                f"{aliased} state leaf(s) kept their storage; contract "
                f"requires >= {contract.min_aliased} (the state is not "
                "written in place)")
    if copies_max > contract.max_copy_bytes:
        violate("copy",
                f"largest copy writes {copies_max} bytes "
                f"(> {contract.max_copy_bytes}): a state buffer is being "
                "copied instead of written in place")
    if host_ops:
        violate("host-transfer",
                f"{len(host_ops)} device-to-host read(s): "
                f"{', '.join(host_ops[:5])}")
    if uploads > contract.max_uploads:
        violate("upload",
                f"{uploads} host-to-device upload(s), {upload_bytes} bytes "
                f"(contract allows {contract.max_uploads})")
    bad_dtypes = dtypes_seen - set(contract.allowed_dtypes)
    if bad_dtypes:
        violate("dtype",
                f"dtype(s) {sorted(bad_dtypes)} outside the contract "
                f"allowlist {sorted(contract.allowed_dtypes)}")
    if cost.coll_bytes > contract.max_collective_bytes:
        violate("collective-bytes",
                f"{cost.coll_bytes:.0f} collective bytes/call "
                f"(> {contract.max_collective_bytes:.0f})")
    if check_hbm and cost.bytes > contract.max_hbm_bytes:
        violate("hbm-bytes",
                f"{cost.bytes:.0f} memory bytes/call "
                f"(> {contract.max_hbm_bytes:.0f})")

    res.stats = {
        "ops": len(trace.records),
        "restacks": len(restacks),
        "aliased_outputs": aliased,
        "max_copy_bytes": copies_max,
        "host_transfer_ops": len(host_ops),
        "uploads": uploads,
        "upload_bytes": upload_bytes,
        "kernel_ops": sum(1 for r in trace.records
                          if r.name in op_cost.KERNEL_OPS),
        "dtypes": sorted(dtypes_seen),
        "hbm_bytes": cost.bytes,
        "collective_bytes": cost.coll_bytes,
        "flops": cost.flops,
    }
    return res


def loosened(current: GraphContract, baseline_limits: Dict) -> List[str]:
    """Which knobs of ``current`` are looser than the baseline recorded?
    Returns human-readable descriptions (empty = nothing loosened)."""
    cur = current.limits_json()
    out = []
    for key in ("max_restacks", "max_copy_bytes", "max_uploads",
                "max_collective_bytes", "max_hbm_bytes"):
        if key in baseline_limits and cur[key] > baseline_limits[key]:
            out.append(f"{key} raised {baseline_limits[key]} -> {cur[key]}")
    if "restack_rank" in baseline_limits \
            and cur["restack_rank"] > baseline_limits["restack_rank"]:
        out.append(f"restack_rank raised {baseline_limits['restack_rank']} "
                   f"-> {cur['restack_rank']} (fewer concats count)")
    if "min_aliased" in baseline_limits \
            and cur["min_aliased"] < baseline_limits["min_aliased"]:
        out.append(f"min_aliased lowered {baseline_limits['min_aliased']} "
                   f"-> {cur['min_aliased']}")
    if baseline_limits.get("require_donation") and not cur["require_donation"]:
        out.append("require_donation disabled")
    extra = set(cur["allowed_dtypes"]) - set(
        baseline_limits.get("allowed_dtypes", cur["allowed_dtypes"]))
    if extra:
        out.append(f"allowed_dtypes grew by {sorted(extra)}")
    return out
