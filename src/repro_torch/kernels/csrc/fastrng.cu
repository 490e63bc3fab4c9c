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
// Bound: instruction issue. hash_normal writes 4 B an element and
// hash_device 8 B, against about 62 and 65-146 integer and float
// operations an element (fastrng.cuh's kHashNormalOps; roofline/op_cost.py,
// DEVICE_*_OPS). Each operation is at least one instruction (--fmad=false:
// no multiply-add pairs them but the exact folds of fastrng.cuh), and the
// card issues one warp instruction a clock on each of its 528 schedulers,
// 33.45e12 thread-instructions a second at 1.98 GHz, half the 67e12
// float32 FLOP/s that count a multiply-add as two. So issue, not bytes
// (3.35e12 B/s) or the FLOP rate, sets their time;
// benchmarks/sass_count.py counts the instructions an element.
//
// Both kernels: each thread draws 4 consecutive elements of a member and
// writes them with one 16-byte store to each output where the member
// starts 16-byte aligned, scalar stores otherwise and at the member's
// ragged end; the index within a member is 32-bit, blockIdx.y walks the
// members, and a thread mixes its member's seed with each salt once.
//
// hash_device: the train step redraws both devices of every tile whose
// device is not stored (core/device.py, sample_device(method="hash")).
// The eager chain wrote three normals (12 B an element) and read and
// wrote them through 7 (no target SP) or 19 float32 passes, 76 or 188 B
// an element. Here one pass writes gamma and rho, 8 B an element, and
// nothing else: the normals, exp, the clips and the target-SP solve stay
// in registers. It draws only the normals the config reads (salt 11 for
// sigma_d2d > 0, 13 without a target SP, 17 with one), the choice fixed
// at compile time by the kernel's template.
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

constexpr int kThreads = 256;
constexpr int kVec = 4;  // elements a thread: one float4 an output

// Stores 4 draws of a member at j0: one float4 where vec and the group is
// whole, element by element up to the member's end otherwise.
__device__ __forceinline__ void store_group(float* o, uint32_t j0,
                                            uint32_t member, bool vec,
                                            const float (&v)[kVec]) {
  if (vec && j0 + kVec <= member) {
    *reinterpret_cast<float4*>(o + j0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (j0 + k < member) o[j0 + k] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
hash_normal_kernel(const int32_t* __restrict__ seeds, float* __restrict__ out,
                   uint32_t n, uint32_t member, bool vec, uint32_t salt) {
  const fastrng::NormalConsts nk = fastrng::normal_consts();
  const uint32_t first = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const uint32_t stride = gridDim.x * kThreads * kVec;
  for (uint32_t m = blockIdx.y; m < n; m += gridDim.y) {
    const fastrng::HashKey key = fastrng::hash_key(
        (uint32_t)seeds[2 * m], (uint32_t)seeds[2 * m + 1], salt);
    float* o = out + (size_t)m * member;
    for (uint32_t j0 = first; j0 < member; j0 += stride) {
      uint32_t bits[kVec];
      float v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        bits[k] = fastrng::hash_bits(j0 + k, key);
      fastrng::normals(bits, nk, v);
      store_group(o, j0, member, vec, v);
    }
  }
}

// The float32 scalars of core/device.py's chain, each as torch rounds it.
struct DeviceScalars {
  float sigma_d2d, sigma_pm, ref_mean, ref_std;
  float w_lo, w_hi;              // -0.95 tau_min, 0.95 tau_max
  float t_sum, t_diff, t_prod2;  // tau_min + tau_max, tau_min - tau_max,
                                 // 2 tau_min tau_max
};

// (gamma, rho) of one element from its normals (salt 11 for gamma, 17 or
// 13 for rho), the eager chain's operations in its order.
template <bool kD2d, bool kTarget>
__device__ __forceinline__ void device_element(float ng, float nr,
                                               const DeviceScalars& c,
                                               float& gamma, float& rho) {
  gamma = kD2d ? expf(__fmul_rn(ng, c.sigma_d2d)) : 1.0f;
  const float lo = __fmul_rn(gamma, (float)-0.95);
  const float hi = __fmul_rn(gamma, (float)0.95);
  float r;
  if (kTarget) {
    float w = __fadd_rn(__fmul_rn(nr, c.ref_std), c.ref_mean);
    w = fastrng::min_nan(fastrng::max_nan(w, c.w_lo), c.w_hi);
    const float num = __fmul_rn(__fmul_rn(w, gamma), c.t_sum);
    const float den = __fadd_rn(__fmul_rn(w, c.t_diff), c.t_prod2);
    r = __fdiv_rn(num, den);
  } else {
    r = __fmul_rn(nr, c.sigma_pm);
  }
  rho = fastrng::min_nan(fastrng::max_nan(r, lo), hi);
}

template <bool kD2d, bool kTarget>
__global__ void __launch_bounds__(kThreads)
hash_device_kernel(const int32_t* __restrict__ seeds,
                   float* __restrict__ gamma, float* __restrict__ rho,
                   uint32_t n, uint32_t member, bool vec, DeviceScalars c) {
  const fastrng::NormalConsts nk = fastrng::normal_consts();
  const uint32_t first = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const uint32_t stride = gridDim.x * kThreads * kVec;
  for (uint32_t m = blockIdx.y; m < n; m += gridDim.y) {
    const uint32_t s0 = (uint32_t)seeds[2 * m];
    const uint32_t s1 = (uint32_t)seeds[2 * m + 1];
    const fastrng::HashKey kg = fastrng::hash_key(s0, s1, 11u);
    const fastrng::HashKey kr =
        fastrng::hash_key(s0, s1, kTarget ? 17u : 13u);
    float* go = gamma + (size_t)m * member;
    float* ro = rho + (size_t)m * member;
    for (uint32_t j0 = first; j0 < member; j0 += stride) {
      uint32_t bg[kVec], br[kVec];
      float ng[kVec] = {}, nr[kVec], g[kVec], r[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        bg[k] = fastrng::hash_bits(j0 + k, kg);
        br[k] = fastrng::hash_bits(j0 + k, kr);
      }
      if (kD2d) fastrng::normals(bg, nk, ng);
      fastrng::normals(br, nk, nr);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        device_element<kD2d, kTarget>(ng[k], nr[k], c, g[k], r[k]);
      store_group(go, j0, member, vec, g);
      store_group(ro, j0, member, vec, r);
    }
  }
}

template <bool kD2d, bool kTarget>
void launch_device(dim3 grid, cudaStream_t stream, const int32_t* seeds,
                   float* gamma, float* rho, uint32_t n, uint32_t member,
                   bool vec, const DeviceScalars& c) {
  hash_device_kernel<kD2d, kTarget><<<grid, kThreads, 0, stream>>>(
      seeds, gamma, rho, n, member, vec, c);
}

constexpr int64_t kPerBlock = (int64_t)kThreads * kVec;

// All 2^23 mantissas through log_div against __fdiv_rn (chip_smoke.py
// phase 3): counts[0] mismatches (bit patterns), counts[1] the first
// differing mantissa's bits, marked with bit 32.
__global__ void log_div_sweep_kernel(unsigned long long* counts) {
  unsigned long long bad = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < (1u << 23);
       i += gridDim.x * blockDim.x) {
    const float mant = __int_as_float((int)(i | 0x3F000000u));
    const float d = __fadd_rn(mant, (float)0.3520887068);
    const float got = fastrng::log_div(d);
    const float want = __fdiv_rn((float)1.72587999, d);
    if (__float_as_uint(got) != __float_as_uint(want)) {
      ++bad;
      atomicCAS(&counts[1], 0ull, (unsigned long long)i | (1ull << 32));
    }
  }
  atomicAdd(&counts[0], bad);
}

}  // namespace

// seeds: n (s0, s1) pairs, the uint32 words as int32; out: n * member
// float32 (member < 2^31); vec: out 16-byte aligned and every member's
// start too (n == 1 or member a multiple of 4). Returns a cudaError_t
// (0 = ok).
extern "C" int hash_normal_launch(const void* seeds, void* out, int64_t n,
                                  int64_t member, uint32_t salt, int vec,
                                  void* stream) {
  if (n <= 0 || member <= 0) return cudaSuccess;
  if (member >= ((int64_t)1 << 31) || n >= ((int64_t)1 << 31))
    return cudaErrorInvalidValue;
  hash_normal_kernel<<<fastrng::grid_of(n, member, kPerBlock), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), static_cast<float*>(out),
      (uint32_t)n, (uint32_t)member, vec != 0, salt);
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
  if (member >= ((int64_t)1 << 31) || n >= ((int64_t)1 << 31))
    return cudaErrorInvalidValue;
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
  const bool vec = n == 1 || member % kVec == 0;
  const dim3 grid = fastrng::grid_of(n, member, kPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sd = static_cast<const int32_t*>(seeds);
  float* g = static_cast<float*>(gamma);
  float* r = static_cast<float*>(rho);
  const uint32_t nn = (uint32_t)n, mb = (uint32_t)member;
  if (d2d && target)
    launch_device<true, true>(grid, st, sd, g, r, nn, mb, vec, c);
  else if (d2d)
    launch_device<true, false>(grid, st, sd, g, r, nn, mb, vec, c);
  else if (target)
    launch_device<false, true>(grid, st, sd, g, r, nn, mb, vec, c);
  else
    launch_device<false, false>(grid, st, sd, g, r, nn, mb, vec, c);
  return cudaGetLastError();
}

// counts: 2 zeroed unsigned 64-bit words on the card
extern "C" int fastrng_log_div_sweep(void* counts, void* stream) {
  log_div_sweep_kernel<<<132 * 8, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}
