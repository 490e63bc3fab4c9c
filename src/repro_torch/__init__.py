"""PyTorch/CUDA port of the ``repro`` analog in-memory training package.

Mirrors ``repro``'s subpackages and modules (``repro.core.pulse`` <->
``repro_torch.core.pulse``) and imports neither ``repro`` nor ``jax``. Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU; the hand-written CUDA kernels live in ``kernels/csrc`` and are built on
first use.
"""

import torch as _torch


def _init_cpu_vector_math() -> None:
    """Make the process's first call into MKL's vector math (VML) on one
    thread. torch's CPU build computes float32/float64 ``sqrt``, ``exp``,
    ``log``, ``log1p``, ``tanh``, ``sin``, ``erfinv`` and the like with VML.
    When a process's first VML call runs on several threads at once, the
    share of the elements of one thread (rarely two) can come out hundreds
    to thousands of ULP off (torch 2.13.0+cpu, MKL 2024.2). One call on one thread, of any
    VML function, initialises it for every function and dtype: 64 elements
    stay below torch's parallel grain."""
    _torch.sqrt(_torch.ones(64, dtype=_torch.float32))


_init_cpu_vector_math()
