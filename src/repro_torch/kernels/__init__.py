"""Hand-written Hopper kernels for the analog-training hot spots, with their
plain PyTorch versions.

  csrc/analog_update.cu — fused pulse update (eq. 2 + stochastic rounding +
                          c2c noise), CUDA C++ for sm_90a
  analog_update.py      — its ctypes binding (operand checks, launch)
  csrc/analog_mvm.cu    — IO-quantized crossbar MVM (DAC, f32 GEMM, noise,
                          ADC), CUDA C++ for sm_90a
  analog_matmul.py      — its ctypes binding
  csrc/sp_filter.cu     — SP-tracking EMA (eq. 12) + its two telemetry
                          sums, CUDA C++ for sm_90a
  sp_filter.py          — its ctypes binding
  cuda_build.py         — nvcc build of csrc/ at first use
  ops.py                — dispatching wrappers and launch counts
  ref.py                — plain PyTorch versions (the math's ground truth)
  fastrng.py            — stateless hash RNG (fastrng port)
  csrc/fastrng.cu       — its normal draw and a tile's device draw (gamma,
                          rho), one pass each, CUDA C++ for sm_90a
"""
from . import fastrng, ops, ref  # noqa: F401
