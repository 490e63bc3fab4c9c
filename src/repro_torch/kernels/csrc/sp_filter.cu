// Chopped-EMA SP-tracking filter (paper eq. 12) with its two telemetry
// reductions, for Hopper (sm_90a).
//
// Replaces the TPU kernel `sp_filter_pallas`
// (src/repro/kernels/sp_filter.py, body `_kernel`). Element-wise over a
// contiguous range of any rank:
//   q_new = (1 - eta) q + eta p                      (written in q's dtype)
//   gp_sq = sum G_p(p)^2,  err_sq = sum (q_new - w_sp)^2   (float32)
// with the soft-bounds G and the closed-form symmetric point w_sp of
// `sp_filter_ref` (src/repro_torch/kernels/ref.py).
//
// Bound: memory. Per float32 element it reads q, p, gamma and rho (16 B)
// and writes q_new (4 B), for ~20 flops. Pass 1 is one grid-stride pass,
// one thread per element; each block reduces its two sums in f32 (warp
// shuffles, then shared memory) to one partial pair. Pass 2, one block,
// adds the partials in a fixed order. There are no float atomics, so the
// sums are bit-identical from run to run. Where the TPU kernel wrote one
// partial per grid block and left the sum to XLA, the card needs the
// second pass because its blocks run in no order.
//
// Parity: the arithmetic is `sp_filter_ref` op for op, uncontracted (built
// with --fmad=false): true IEEE divisions by tau_min and tau_max (not the
// Pallas body's reciprocal multiplies), and 1 - eta and eta handed over as
// float32 by the host, as torch rounds Python scalars. q_new is bit-equal
// to the plain version; the sums differ from it only in summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Sums a and b over the block in a fixed tree; thread 0 gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[WARPS], sb[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
    b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < WARPS ? sa[lane] : 0.0f;
    b = lane < WARPS ? sb[lane] : 0.0f;
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1) {
      a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
      b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
    }
  }
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS)
sp_filter_pass1(const TQ* __restrict__ q, const TP* __restrict__ p,
                const float* __restrict__ gamma, const float* __restrict__ rho,
                TQ* __restrict__ q_out, float* __restrict__ partials,
                int64_t size, float eta, float one_minus_eta, float tau_min,
                float tau_max) {
  float gp = 0.0f, err = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < size;
       i += stride) {
    const float qf = to_f32(q[i]);
    const float pf = to_f32(p[i]);
    const float gam = gamma[i];
    const float rh = rho[i];

    const float q_new = __fadd_rn(__fmul_rn(one_minus_eta, qf),
                                  __fmul_rn(eta, pf));
    store(q_out + i, q_new);

    // G_p(p) of the soft-bounds response
    const float a_p = __fadd_rn(gam, rh);
    const float a_m = __fsub_rn(gam, rh);
    const float qp = __fmul_rn(a_p, __fsub_rn(1.0f, __fdiv_rn(pf, tau_max)));
    const float qm = __fmul_rn(a_m, __fadd_rn(1.0f, __fdiv_rn(pf, tau_min)));
    const float g = __fmul_rn(__fsub_rn(qm, qp), 0.5f);
    gp = __fadd_rn(gp, __fmul_rn(g, g));

    // SP tracking error against the closed-form symmetric point
    const float w_sp = __fdiv_rn(
        __fsub_rn(a_p, a_m),
        __fadd_rn(__fdiv_rn(a_p, tau_max), __fdiv_rn(a_m, tau_min)));
    const float d = __fsub_rn(q_new, w_sp);
    err = __fadd_rn(err, __fmul_rn(d, d));
  }
  block_sum2(gp, err);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = gp;
    partials[2 * blockIdx.x + 1] = err;
  }
}

// One block: thread t adds partials t, t + THREADS, ... in order, then the
// block adds the threads' sums in a fixed tree.
__global__ void __launch_bounds__(THREADS)
sp_filter_pass2(const float* __restrict__ partials, int blocks,
                float* __restrict__ sums) {
  float gp = 0.0f, err = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
    gp = __fadd_rn(gp, partials[2 * b]);
    err = __fadd_rn(err, partials[2 * b + 1]);
  }
  block_sum2(gp, err);
  if (threadIdx.x == 0) {
    sums[0] = gp;
    sums[1] = err;
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* p, const float* gamma,
                   const float* rho, void* q_out, float* partials,
                   float* sums, int64_t size, int blocks, float eta,
                   float one_minus_eta, float tau_min, float tau_max,
                   cudaStream_t stream) {
  if (blocks < 1) return cudaErrorInvalidValue;
  sp_filter_pass1<TQ, TP><<<blocks, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(p), gamma, rho,
      static_cast<TQ*>(q_out), partials, size, eta, one_minus_eta, tau_min,
      tau_max);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sp_filter_pass2<<<1, THREADS, 0, stream>>>(partials, blocks, sums);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q_out has q's dtype. `blocks`
// is pass 1's grid (the wrapper sizes `partials` to 2 * blocks floats);
// `sums` receives (gp_sq, err_sq). Returns a cudaError_t (0 = ok).
extern "C" int sp_filter_launch(
    int q_dtype, int p_dtype, const void* q, const void* p, const void* gamma,
    const void* rho, void* q_out, void* partials, void* sums, int64_t size,
    int blocks, float eta, float one_minus_eta, float tau_min, float tau_max,
    void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* r = static_cast<const float*>(rho);
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && p_dtype == 0)
    return launch<float, float>(q, p, g, r, q_out, part, out, size, blocks,
                                eta, one_minus_eta, tau_min, tau_max, s);
  if (q_dtype == 0 && p_dtype == 1)
    return launch<float, __nv_bfloat16>(q, p, g, r, q_out, part, out, size,
                                        blocks, eta, one_minus_eta, tau_min,
                                        tau_max, s);
  if (q_dtype == 1 && p_dtype == 0)
    return launch<__nv_bfloat16, float>(q, p, g, r, q_out, part, out, size,
                                        blocks, eta, one_minus_eta, tau_min,
                                        tau_max, s);
  if (q_dtype == 1 && p_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, p, g, r, q_out, part, out,
                                                size, blocks, eta,
                                                one_minus_eta, tau_min,
                                                tau_max, s);
  return (int)cudaErrorInvalidValue;
}
