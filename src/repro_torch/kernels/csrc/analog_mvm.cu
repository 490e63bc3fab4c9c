// IO-quantized analog crossbar MVM (paper Table 7) for Hopper (sm_90a).
//
// Replaces the TPU kernel `analog_mvm_pallas`
// (src/repro/kernels/analog_matmul.py, body `_kernel`). Computes
//   out = round_adc(clip(q_dac(x / s) @ w + out_noise * noise)) * s
// for x (M, K), w (K, N), the (M, 1) ABS_MAX row scale s (computed by the
// wrapper) and standard normals (M, N), as `analog_mvm_ref`
// (src/repro_torch/kernels/ref.py) does.
//
// Bound: operations at the shapes that matter (2 M N K flops over
// 4 (M K + K N + 2 M N) + 4 M bytes; 17.9 GFLOP against 28 MB at
// (2048, 896) @ (896, 4864)). The Pallas kernel feeds the TPU's matrix unit
// in f32; here the reference dots are f32 too, so this first version is a
// tiled SIMT GEMM on the CUDA cores (67 TFLOP/s f32 peak), not a tensor-core
// one: TF32 would break parity with the f32 reference. Each block computes a
// BM x BN output tile over K in steps of BK, with both operand tiles in
// shared memory and a TM x TN micro-tile of f32 accumulators per thread.
// The x tile is quantized as it is loaded (the DAC is fused into the
// prologue), and noise, ADC and rescale are fused into the epilogue, so x
// and the output each make one trip through device memory. Ragged M, N and
// K are bounds-checked, so nothing is padded. The launcher takes 64 x 64
// tiles when they give at least two blocks per SM, else 32 x 32 tiles so a
// small product still spreads over more SMs.
//
// Parity: the accumulation is an explicit fmaf chain in k order (built with
// --fmad=false, which leaves fmaf alone); prologue and epilogue are
// uncontracted IEEE ops: a true division by s, rintf (half to even, as
// torch.round and jnp.round), and the reciprocals 1/inp_res, 1/out_res
// handed over as float32 by the host, as the plain version multiplies by
// them. The only difference from the plain version is the matmul's
// summation order, which can move y across an ADC rounding boundary: at
// most one ADC step (out_res * s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int SMS = 132;  // H100 SXM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// min(max(x, lo), hi), as torch.clamp and jnp.clip.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

struct IO {
  float inp_res, inv_inp_res, inp_bound;
  float out_res, inv_out_res, out_bound, out_noise;
};

// TM (resp. TN) consecutive floats of a shared-memory row; 8- or 16-byte
// aligned by construction of the tile strides below.
template <int T>
__device__ __forceinline__ void load_frag(float (&r)[T], const float* p) {
  if constexpr (T == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (T == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) r[i] = p[i];
  }
}

template <typename TX, typename TW, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
analog_mvm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ noise,
                  TX* __restrict__ out, int M, int N, int K, IO io) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile a thread");
  static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0, "");
  // x tile stored k-major (transposed) so a thread's TM rows are adjacent;
  // the pad keeps rows 16-byte aligned and spreads the transposed stores.
  constexpr int AS = BM + 4;
  __shared__ __align__(16) float As[BK][AS];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: coalesced along k, quantized by the input DAC on the way in
#pragma unroll
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.0f;
      if (m < M && k < K) {
        const float xn = __fdiv_rn(to_f32(x[(size_t)m * K + k]), s[m]);
        const float xc = clamp(xn, -io.inp_bound, io.inp_bound);
        v = __fmul_rn(rintf(__fmul_rn(xc, io.inv_inp_res)), io.inp_res);
      }
      As[c][r] = v;
    }
    // w tile: coalesced along n
#pragma unroll
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? to_f32(w[(size_t)k * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      load_frag<TM>(a, &As[kk][ty * TM]);
      load_frag<TN>(b, &Bs[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: output noise, ADC clip and rounding, rescale, cast
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float sm = s[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      float y = __fadd_rn(acc[i][j], __fmul_rn(io.out_noise, noise[o]));
      y = clamp(y, -io.out_bound, io.out_bound);
      y = __fmul_rn(rintf(__fmul_rn(y, io.inv_out_res)), io.out_res);
      store(out + o, __fmul_rn(y, sm));
    }
  }
}

template <typename TX, typename TW, int BM, int BN, int TM, int TN>
cudaError_t launch_tiles(const void* x, const void* w, const float* s,
                         const float* noise, void* out, int M, int N, int K,
                         const IO& io, cudaStream_t stream) {
  // row tiles on x (up to 2^31 - 1 blocks), column tiles on y (65535)
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  analog_mvm_kernel<TX, TW, BM, BN, TM, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), s, noise,
      static_cast<TX*>(out), M, N, K, io);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const float* s,
                   const float* noise, void* out, int M, int N, int K,
                   const IO& io, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const long long big = (long long)((M + 63) / 64) * ((N + 63) / 64);
  if (big >= 2 * SMS)
    return launch_tiles<TX, TW, 64, 64, 4, 4>(x, w, s, noise, out, M, N, K,
                                              io, stream);
  return launch_tiles<TX, TW, 32, 32, 2, 2>(x, w, s, noise, out, M, N, K, io,
                                            stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; the output has x's dtype.
// Returns a cudaError_t (0 = ok).
extern "C" int analog_mvm_launch(
    int x_dtype, int w_dtype, const void* x, const void* w, const void* s,
    const void* noise, void* out, int M, int N, int K, float inp_res,
    float inv_inp_res, float inp_bound, float out_res, float inv_out_res,
    float out_bound, float out_noise, void* stream) {
  const IO io{inp_res, inv_inp_res, inp_bound, out_res, inv_out_res,
              out_bound, out_noise};
  const float* sf = static_cast<const float*>(s);
  const float* nf = static_cast<const float*>(noise);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, sf, nf, out, M, N, K, io, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, sf, nf, out, M, N, K, io, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, sf, nf, out, M, N, K, io, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, sf, nf, out, M, N, K,
                                                io, st);
  return (int)cudaErrorInvalidValue;
}
