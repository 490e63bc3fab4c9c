"""Hand-written Hopper kernels for the analog-training hot spots, with their
plain PyTorch versions.

  csrc/analog_update.cu — fused pulse update (eq. 2 + stochastic rounding +
                          c2c noise), CUDA C++ for sm_90a
  analog_update.py      — its ctypes binding (operand checks, launch)
  cuda_build.py         — nvcc build of csrc/ at first use
  ops.py                — dispatching wrappers and launch counts
  ref.py                — plain PyTorch versions (the math's ground truth)
  fastrng.py            — stateless hash RNG (fastrng port)
"""
from . import fastrng, ops, ref  # noqa: F401
