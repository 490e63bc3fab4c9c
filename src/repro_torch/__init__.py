"""PyTorch/CUDA port of the ``repro`` analog in-memory training package.

Mirrors ``repro``'s subpackages and modules (``repro.core.pulse`` <->
``repro_torch.core.pulse``) and imports neither ``repro`` nor ``jax``. Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU; the hand-written CUDA kernels live in ``kernels/csrc`` and are built on
first use.
"""
