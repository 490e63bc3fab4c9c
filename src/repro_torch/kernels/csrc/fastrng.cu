// The hash RNG's kernels for Hopper (sm_90a), from csrc/fastrng.cuh:
// hash_normal, float32 standard normals of an (n, *member) stack from n
// seeds and a salt, and hash_device, a tile's device parameters (gamma,
// rho) in one pass.
//
// Neither replaces a Pallas kernel. They are the Hopper form of jnp code:
// src/repro/kernels/fastrng.py, and the hash branch of
// src/repro/core/device.py's sample_device, whose element-wise chains XLA
// fuses into one loop. Eager torch cannot fuse them: the plain versions
// (kernels/fastrng.py's hash_normal_ref and hash_device_ref) run each
// uint32 step as an int64 operation with
// a mask and each float step as its own pass, one launch and one
// temporary of the draw's size per step.
//
// hash_normal: one pass writes the draws, 4 B an element. About 62
// integer and float operations (fastrng.cuh, kHashNormalOps) against 4 B
// written per element, so operations bind at 62 / 67e12 s against
// 4 / 3.35e12 s an element. One thread per element in a grid-stride loop;
// blockIdx.y walks the members, so a member's seed is read once per block
// and the linear index (restarting per member, as a uint32 that wraps)
// needs no 64-bit division. lifetime/drift.py's normals take it.
//
// hash_device: the train step redraws both devices of every tile whose
// device is not stored (core/device.py, sample_device(method="hash")).
// The eager chain wrote three normals (12 B an element) and read and
// wrote them through 7 (no target SP) or 19 float32 passes, 76 or 188 B
// an element. Here one pass writes gamma and rho, 8 B an element, and
// nothing else: the normals, exp, the clips and the target-SP solve stay
// in registers. It draws only the normals the config reads (salt 11 for
// sigma_d2d > 0, 13 without a target SP, 17 with one), the choice fixed
// at compile time by the kernel's template. Each thread writes 4
// consecutive elements with one 16-byte store to each output where the
// member is 4-aligned, scalar stores otherwise and at the member's ragged
// end; the index within a member is 32-bit and blockIdx.y walks the
// members, each thread loading its member's seed once. Bound: 8 B an
// element against 65-146 operations (roofline/op_cost.py, DEVICE_*_OPS,
// counted as fastrng.cuh counts the normal's), near the
// balance point of the card (67e12 / 3.35e12 = 20 operations a byte). It
// runs at about hash_normal's instruction rate: each operation is its own
// instruction (no multiply-add may pair them) and the normals' integer
// conversions and IEEE divisions take several, so instruction
// throughput, not bytes, sets its time.
//
// Parity: bit-equal to the eager chains on the card (see fastrng.cuh).
// hash_device rounds once per eager operation in the eager order: the
// products and sums by the _rn intrinsics, the division by __fdiv_rn,
// exp by expf as torch's CUDA exp calls it, the clamps and clips as
// torch.clamp / torch.maximum / torch.minimum (a NaN passes). Every
// Python scalar becomes float as torch casts it: the double from Python's
// arithmetic, rounded once.
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

// torch.maximum / torch.minimum (a NaN in either operand propagates)
__device__ __forceinline__ float torch_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float torch_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(v, lo, hi) with scalar bounds
__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// The float32 scalars of core/device.py's chain, each as torch rounds it.
struct DeviceScalars {
  float sigma_d2d, sigma_pm, ref_mean, ref_std;
  float w_lo, w_hi;              // -0.95 tau_min, 0.95 tau_max
  float t_sum, t_diff, t_prod2;  // tau_min + tau_max, tau_min - tau_max,
                                 // 2 tau_min tau_max
};

// (gamma, rho) of one element, the eager chain's operations in its order.
template <bool kD2d, bool kTarget>
__device__ __forceinline__ void device_element(uint32_t j, uint32_t s0,
                                               uint32_t s1,
                                               const DeviceScalars& c,
                                               float& gamma, float& rho) {
  gamma = kD2d ? expf(__fmul_rn(fastrng::hash_normal(j, s0, s1, 11),
                                c.sigma_d2d))
               : 1.0f;
  const float lo = __fmul_rn(gamma, (float)-0.95);
  const float hi = __fmul_rn(gamma, (float)0.95);
  float r;
  if (kTarget) {
    float w = __fadd_rn(__fmul_rn(fastrng::hash_normal(j, s0, s1, 17),
                                  c.ref_std),
                        c.ref_mean);
    w = torch_clamp(w, c.w_lo, c.w_hi);
    const float num = __fmul_rn(__fmul_rn(w, gamma), c.t_sum);
    const float den = __fadd_rn(__fmul_rn(w, c.t_diff), c.t_prod2);
    r = __fdiv_rn(num, den);
  } else {
    r = __fmul_rn(fastrng::hash_normal(j, s0, s1, 13), c.sigma_pm);
  }
  rho = torch_min(torch_max(r, lo), hi);
}

constexpr int kDeviceThreads = 256;
constexpr int kDeviceVec = 4;  // elements a thread: one float4 an output

template <bool kD2d, bool kTarget>
__global__ void __launch_bounds__(kDeviceThreads)
hash_device_kernel(const int32_t* __restrict__ seeds,
                   float* __restrict__ gamma, float* __restrict__ rho,
                   int64_t n, uint32_t member, bool vec, DeviceScalars c) {
  const uint32_t j0 =
      (blockIdx.x * kDeviceThreads + threadIdx.x) * kDeviceVec;
  if (j0 >= member) return;
  for (int64_t m = blockIdx.y; m < n; m += gridDim.y) {
    const uint32_t s0 = (uint32_t)seeds[2 * m];
    const uint32_t s1 = (uint32_t)seeds[2 * m + 1];
    float g[kDeviceVec], r[kDeviceVec];
#pragma unroll
    for (int k = 0; k < kDeviceVec; ++k)
      device_element<kD2d, kTarget>(j0 + k, s0, s1, c, g[k], r[k]);
    float* go = gamma + m * (int64_t)member + j0;
    float* ro = rho + m * (int64_t)member + j0;
    if (vec && j0 + kDeviceVec <= member) {
      *reinterpret_cast<float4*>(go) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<float4*>(ro) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kDeviceVec; ++k)
        if (j0 + k < member) {
          go[k] = g[k];
          ro[k] = r[k];
        }
    }
  }
}

template <bool kD2d, bool kTarget>
void launch_device(dim3 grid, cudaStream_t stream, const int32_t* seeds,
                   float* gamma, float* rho, int64_t n, uint32_t member,
                   bool vec, const DeviceScalars& c) {
  hash_device_kernel<kD2d, kTarget><<<grid, kDeviceThreads, 0, stream>>>(
      seeds, gamma, rho, n, member, vec, c);
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

// seeds: n (s0, s1) pairs, the uint32 words as int32; gamma, rho: n *
// member float32 each, 16-byte aligned; member < 2**31. The config's
// scalars as Python holds them (double). Returns a cudaError_t (0 = ok).
extern "C" int hash_device_launch(const void* seeds, void* gamma, void* rho,
                                  int64_t n, int64_t member,
                                  double sigma_d2d, double sigma_pm,
                                  double ref_mean, double ref_std,
                                  double tau_min, double tau_max,
                                  void* stream) {
  if (n <= 0 || member <= 0) return cudaSuccess;
  if (member >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  DeviceScalars c;
  c.sigma_d2d = (float)sigma_d2d;
  c.sigma_pm = (float)sigma_pm;
  c.ref_mean = (float)ref_mean;
  c.ref_std = (float)ref_std;
  c.w_lo = (float)(-0.95 * tau_min);
  c.w_hi = (float)(0.95 * tau_max);
  c.t_sum = (float)(tau_min + tau_max);
  c.t_diff = (float)(tau_min - tau_max);
  c.t_prod2 = (float)(2.0 * tau_min * tau_max);
  const bool d2d = sigma_d2d > 0;
  const bool target = ref_mean != 0.0 || ref_std != 0.0;
  const bool vec = member % kDeviceVec == 0;
  const int64_t per_block = (int64_t)kDeviceThreads * kDeviceVec;
  const dim3 grid((unsigned)((member + per_block - 1) / per_block),
                  (unsigned)(n < 65535 ? n : 65535));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sd = static_cast<const int32_t*>(seeds);
  float* g = static_cast<float*>(gamma);
  float* r = static_cast<float*>(rho);
  const uint32_t mb = (uint32_t)member;
  if (d2d && target)
    launch_device<true, true>(grid, st, sd, g, r, n, mb, vec, c);
  else if (d2d)
    launch_device<true, false>(grid, st, sd, g, r, n, mb, vec, c);
  else if (target)
    launch_device<false, true>(grid, st, sd, g, r, n, mb, vec, c);
  else
    launch_device<false, false>(grid, st, sd, g, r, n, mb, vec, c);
  return cudaGetLastError();
}
