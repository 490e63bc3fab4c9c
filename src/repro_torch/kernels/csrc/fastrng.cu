// One-pass hash_normal for Hopper (sm_90a): float32 standard normals of an
// (n, *member) stack from n seeds and a salt.
//
// Replaces no Pallas kernel. It is the Hopper form of a jnp module,
// src/repro/kernels/fastrng.py, whose short element-wise chain XLA fuses
// into its consumer. Eager torch cannot fuse it: the plain version
// (src/repro_torch/kernels/fastrng.py, hash_normal_ref) runs each uint32
// step as an int64 operation with a mask, one launch and one int64
// temporary of the draw's size per step. Here one pass writes the draws,
// 4 B an element, with no temporaries. The train step draws its device
// parameters (core/device.py, sample_device(method="hash"), salts 11, 13
// and 17) through it.
//
// Bound: about 62 integer and float operations (fastrng.cuh,
// kHashNormalOps) against 4 B written per element, so operations bind at
// 62 / 67e12 s against 4 / 3.35e12 s an element. One thread per element
// in a grid-stride loop; blockIdx.y walks the members, so a member's seed
// is read once per block and the linear index (restarting per member, as
// a uint32 that wraps) needs no 64-bit division.
//
// Parity: bit-equal to the eager chain on the card (see fastrng.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastrng.cuh"

namespace {

__global__ void hash_normal_kernel(const int32_t* __restrict__ seeds,
                                   float* __restrict__ out, int64_t n,
                                   int64_t member, uint32_t salt) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t m = blockIdx.y; m < n; m += gridDim.y) {
    const uint32_t s0 = (uint32_t)seeds[2 * m];
    const uint32_t s1 = (uint32_t)seeds[2 * m + 1];
    float* o = out + m * member;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < member; j += stride)
      o[j] = fastrng::hash_normal((uint32_t)j, s0, s1, salt);
  }
}

}  // namespace

// seeds: n (s0, s1) pairs, the uint32 words as int32; out: n * member
// float32. Returns a cudaError_t (0 = ok).
extern "C" int hash_normal_launch(const void* seeds, void* out, int64_t n,
                                  int64_t member, uint32_t salt,
                                  void* stream) {
  if (n <= 0 || member <= 0) return cudaSuccess;
  const int threads = 256;
  const int64_t gy = n < 65535 ? n : 65535;
  int64_t gx = (member + threads - 1) / threads;
  int64_t cap = 132 * 32 / gy;  // about 32 blocks an SM in all
  if (cap < 1) cap = 1;
  if (gx > cap) gx = cap;
  hash_normal_kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), static_cast<float*>(out), n,
      member, salt);
  return cudaGetLastError();
}
