"""Shared vocabulary of the port's op traces: dtype widths, the forbidden
dtypes, and one record per dispatched operation.

Port of the JAX package's ``roofline/hlo_common.py``. The JAX package reads
XLA's optimized HLO text; the port has no compiled graph, and its
counterpart is the stream of ATen operations an eager step dispatches
(``op_cost.OpTrace`` records it, on the CPU, on the card or on ``meta``).
An ``OpRecord`` is one line of that stream: the operation's name, the
shapes, dtypes and devices of its tensor inputs and outputs, which inputs
it writes in place, and whether it reads a device tensor to the host or
uploads a host tensor to a device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

# bytes per element of every dtype a trace may carry, by torch's name
DTYPE_BYTES: Dict[str, int] = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3fnuz": 1,
    "float8_e5m2fnuz": 1,
    "int64": 8, "uint64": 8, "int32": 4, "uint32": 4, "int16": 2,
    "uint16": 2, "int8": 1, "uint8": 1, "bool": 1,
    "complex64": 8, "complex128": 16,
}

# the port trains and serves in <= 32-bit: a 64-bit float is an accident
FORBIDDEN_DTYPES = frozenset(("float64", "complex64", "complex128"))

# ops that read a tensor's value to the host (``.item()``, ``float(t)``,
# ``int(t)``, ``bool(t)``)
SCALAR_READ_OPS = frozenset(("aten._local_scalar_dense.default",))
# ops that copy a tensor from one device to another
COPY_OPS = frozenset(("aten._to_copy.default", "aten.copy_.default",
                      "aten.copy.default"))


_NAMES: Dict[torch.dtype, str] = {}


def dtype_name(dtype: torch.dtype) -> str:
    name = _NAMES.get(dtype)
    if name is None:
        name = _NAMES[dtype] = str(dtype).replace("torch.", "")
    return name


class TensorMeta(NamedTuple):
    """What a record keeps of one tensor: shape, dtype and device by name."""
    shape: Tuple[int, ...]
    dtype: str
    device: str

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorMeta":
        dev = "meta" if t.is_meta else "cuda" if t.is_cuda else t.device.type
        name = _NAMES.get(t.dtype) or dtype_name(t.dtype)
        return cls(t.shape, name, dev)

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * DTYPE_BYTES.get(self.dtype, 0)


class OpRecord(NamedTuple):
    """One dispatched operation. ``mutated`` indexes ``inputs`` (the tensor
    arguments in order) that the op writes in place; ``host_read`` is set
    when it reads a device tensor to the host, ``upload_bytes`` when it
    copies a host tensor to a device; ``elem_ops``: an element-wise
    kernel's operations an element (``op_cost.ELEMENT_OPS``), else 0."""
    name: str
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    mutated: Tuple[int, ...] = ()
    host_read: bool = False
    upload_bytes: int = 0
    elem_ops: int = 0

    @property
    def short(self) -> str:
        """``aten.mm`` for ``aten.mm.default``."""
        parts = self.name.split(".")
        return ".".join(parts[:2])

    def dtypes(self):
        return {m.dtype for m in self.inputs + self.outputs}

    def operand_bytes(self) -> int:
        return sum(m.nbytes for m in self.inputs)

    def result_bytes(self) -> int:
        return sum(m.nbytes for m in self.outputs)
