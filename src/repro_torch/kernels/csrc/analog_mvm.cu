// IO-quantized analog crossbar MVM (paper Table 7) for Hopper (sm_90a).
//
// Replaces the TPU kernel `analog_mvm_pallas`
// (src/repro/kernels/analog_matmul.py, body `_kernel`). Computes
//   out = round_adc(clip(q_dac(x / s) @ w + out_noise * noise)) * s
// for x (M, K), w (K, N), the (M, 1) ABS_MAX row scale s and standard
// normals (M, N), as `analog_mvm_ref` (src/repro_torch/kernels/ref.py) does.
// One call is two launches:
//
// 1. `dac_codes_kernel`, one warp per row of x: s = max(max|x|, 1e-12) and
//    the integer DAC codes rint(clip(x / s) / inp_res), written as bf16
//    (M, K) with s as f32 (M, 1). Each x element is quantized once.
// 2. `mvm_kernel`, the product of the codes with w on the tensor cores and
//    the epilogue. An f32 w is split in shared memory into three bf16
//    pieces, hi = bf16_rz(w) (cut toward zero, so it never overflows),
//    mid = bf16_rn(w - hi), lo = bf16_rn(w - hi - mid), whose sum is w
//    exactly (for |w| >= 2^-110; below, within 2^-134). The
//    codes are integers with |code| <= 256, exact in bf16, so every product
//    of a code and a piece is exact in f32 and the three bf16 products
//    (`wmma` m16n16k16 fragments, f32 accumulators) give sum_k code * w
//    with f32 sums. A bf16 w is its own hi piece: one pass, not three.
//    Epilogue: y = acc * inp_res, output noise, ADC clip and rounding,
//    rescale by s, cast to x's dtype.
//
// Bound: operations at the shapes that matter, 6 M N K bf16 tensor-core
// flops (2 M N K for a bf16 w) at 989 TFLOP/s against
// 4 (M K + K N + 2 M N) + 4 M bytes at 3.35 TB/s: 54 us against 31 us at
// (2048, 896) @ (896, 4864). The design: the codes (2 bytes) and the f32 w
// tiles stream through a `cp.async` ring in shared memory, D tiles ahead of
// the one multiplied; each K step multiplies tile t while its warps split
// tile t + 1 into the other set of pieces, with one barrier a step. The
// block's noise tile is copied with its last w tile, and the epilogue
// reads its sums and noise from shared memory and writes whole rows of
// out. A block holds one tile of 128 x 128 outputs (8 warps of 64 x 32)
// when there are enough to fill the card, else 64 x 64 or 32 x 64. No
// TF32 anywhere.
//
// Parity: the accumulation order differs from the plain version's f32
// product, and a tensor core may not round each of its additions as an IEEE
// f32 add does. So each BK step sums into a fragment restarted from zero,
// smallest pieces first (all lo products, then mid, then hi), and that
// partial sum is added into the running f32 sum with an IEEE add. The
// prologue and epilogue are the plain version's uncontracted IEEE ops
// (built with --fmad=false): a true division by s, rintf (half to even,
// as torch.round and jnp.round), and the reciprocals 1/inp_res, 1/out_res
// handed over as float32 by the host. The plain version rounds
// code * inp_res per element before its product; here inp_res multiplies
// the exact sum once. Both differences can move y across an ADC rounding
// boundary: at most one ADC step (out_res * s).
//
// Ragged M, N and K are bounds-checked with zero-filled tile edges: a 16-
// byte chunk that lies inside the operand and is 16-byte aligned goes
// through cp.async, any other is loaded element by element. Nothing is
// padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SMS = 132;      // H100 SXM
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.0f); }

// min(max(x, lo), hi), as torch.clamp and jnp.clip.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// what the product kernel's epilogue needs of the IO settings
struct IO {
  float inp_res, out_res, inv_out_res, out_bound, out_noise;
};

// ---------------------------------------------------------------------------
// 1. the DAC: row scale and codes, one warp per row
// ---------------------------------------------------------------------------

template <typename TX>
__global__ void __launch_bounds__(THREADS)
dac_codes_kernel(const TX* __restrict__ x, bf16* __restrict__ codes,
                 float* __restrict__ s, int M, int K, float inv_inp_res,
                 float inp_bound) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= M) return;
  const TX* xr = x + row * K;
  bf16* cr = codes + row * K;
  float mx = 0.0f;
  for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(to_f32(xr[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float sm = fmaxf(mx, 1e-12f);  // torch.clamp_min(amax, 1e-12)
  if (lane == 0) s[row] = sm;
  for (int k = lane; k < K; k += 32) {
    const float xn = __fdiv_rn(to_f32(xr[k]), sm);
    const float xc = clamp(xn, -inp_bound, inp_bound);
    cr[k] = __float2bfloat16_rn(rintf(__fmul_rn(xc, inv_inp_res)));
  }
}

// ---------------------------------------------------------------------------
// 2. codes @ w on the tensor cores, with the epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major (rows, cols)
// operand into a shared tile with row stride LD, zero outside the operand.
// 16-byte chunks inside the operand go through cp.async when `vec` says
// rows are 16-byte aligned; the rest are loaded element by element.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ sm,
                                          const T* __restrict__ g, int rows,
                                          int cols, int r0, int c0, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CHUNKS = R * C / V;
  static_assert(C % V == 0, "whole chunks a row");
#pragma unroll
  for (int e = 0; e < (CHUNKS + THREADS - 1) / THREADS; ++e) {
    const int idx = threadIdx.x + e * THREADS;
    if (CHUNKS % THREADS != 0 && idx >= CHUNKS) break;
    const int r = idx / (C / V), c = (idx % (C / V)) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* dst = sm + r * LD + c;
    if (vec && gr < rows && gc + V <= cols) {
      cp_async16(dst, g + (size_t)gr * cols + gc);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        dst[v] = (gr < rows && gc + v < cols) ? g[(size_t)gr * cols + gc + v]
                                              : zero<T>();
    }
  }
}

// Block tile BM x BN over K in steps of BK; 8 warps as WM x WN, each warp
// FM x FN fragments of 16 x 16. Tile t + D is copied while tile t is
// multiplied, in a ring of D + 1 stages.
template <int BM_, int BN_, int BK_, int WM_, int D_>
struct Tiles {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, D = D_;
  static constexpr int STAGES = D + 1;
  static constexpr int WM = WM_, WN = WARPS / WM_;
  static constexpr int FM = BM / (16 * WM), FN = BN / (16 * WN);
  static constexpr int KF = BK / 16;
  static constexpr int LDA = BK + 8;   // bf16 codes stage, row stride
  static constexpr int LDH = BN + 8;   // bf16 pieces (and bf16 w stage)
  static constexpr int LDF = BN + 4;   // f32 w stage
  static_assert(FM * 16 * WM == BM && FN * 16 * WN == BN, "warp tiling");
  static_assert(D >= 2, "the split reads the tile after the one multiplied");
};

// Shared memory: the ring of code tiles and w tiles, and for an f32 w two
// sets of its three bf16 pieces (one multiplied while the next is split).
// After the loop the same bytes hold the block's f32 sums for the epilogue.
// Past them, the block's tile of output noise, copied with the last w tile
// so that the epilogue does not wait on device memory.
template <typename C, typename TW>
struct Smem {
  static constexpr bool SPLIT = sizeof(TW) == 4;
  static constexpr int LDW = SPLIT ? C::LDF : C::LDH;
  static constexpr size_t A_STAGE = (size_t)C::BM * C::LDA * sizeof(bf16);
  static constexpr size_t W_STAGE = (size_t)C::BK * LDW * sizeof(TW);
  static constexpr size_t PIECE = (size_t)C::BK * C::LDH * sizeof(bf16);
  static constexpr size_t A_OFF = 0;
  static constexpr size_t W_OFF = C::STAGES * A_STAGE;
  static constexpr size_t P_OFF = W_OFF + C::STAGES * W_STAGE;
  static constexpr size_t LOOP = P_OFF + (SPLIT ? 2 * 3 * PIECE : 0);
  static constexpr size_t SUMS = (size_t)C::BM * C::BN * sizeof(float);
  static constexpr size_t N_OFF = LOOP > SUMS ? LOOP : SUMS;
  static constexpr size_t BYTES = N_OFF + SUMS;
  static_assert(A_STAGE % 32 == 0 && W_STAGE % 32 == 0 && PIECE % 32 == 0,
                "wmma needs 32-byte aligned tiles");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// four bf16 as 8 bytes, the first in the lowest bits (little endian)
__device__ __forceinline__ uint2 pack4(const bf16 (&v)[4]) {
  const auto u = [&](int i) { return (unsigned)__bfloat16_as_ushort(v[i]); };
  return make_uint2(u(0) | u(1) << 16, u(2) | u(3) << 16);
}

// hi (cut toward zero), mid and lo of 4 f32 values of a w stage row into
// the three piece tiles, 8 bytes a store.
__device__ __forceinline__ void split4(const float* __restrict__ src,
                                       bf16* __restrict__ hi, size_t piece,
                                       int o) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  const float f[4] = {v.x, v.y, v.z, v.w};
  bf16 h[4], m[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    h[u] = __float2bfloat16_rz(f[u]);
    const float r1 = __fsub_rn(f[u], __bfloat162float(h[u]));
    m[u] = __float2bfloat16_rn(r1);
    l[u] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(m[u])));
  }
  *reinterpret_cast<uint2*>(hi + o) = pack4(h);
  *reinterpret_cast<uint2*>(hi + piece + o) = pack4(m);
  *reinterpret_cast<uint2*>(hi + 2 * piece + o) = pack4(l);
}

template <typename TX, typename TW, typename C>
__global__ void __launch_bounds__(THREADS, 1)
mvm_kernel(const bf16* __restrict__ codes, const TW* __restrict__ w,
           const float* __restrict__ s, const float* __restrict__ noise,
           TX* __restrict__ out, int M, int N, int K, bool vec_a, bool vec_w,
           bool vec_n, IO io) {
  using S = Smem<C, TW>;
  constexpr size_t A_ELEMS = S::A_STAGE / sizeof(bf16);
  constexpr size_t W_ELEMS = S::W_STAGE / sizeof(TW);
  constexpr size_t P_ELEMS = S::PIECE / sizeof(bf16);
  constexpr int NP = S::SPLIT ? 3 : 1;  // pieces of w
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + S::A_OFF);
  TW* Ws = reinterpret_cast<TW*>(smem + S::W_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + S::P_OFF);
  float* Ns = reinterpret_cast<float*>(smem + S::N_OFF);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int steps = (K + C::BK - 1) / C::BK;

  // copy tile t into its ring slot, and the noise tile with the last; one
  // cp.async group a tile, empty past the last, so that wait_group counts
  // stay exact
  auto load = [&](int t) {
    if (t < steps) {
      const int slot = t % C::STAGES;
      load_tile<bf16, C::BM, C::BK, C::LDA>(As + slot * A_ELEMS, codes, M, K,
                                            m0, t * C::BK, vec_a);
      load_tile<TW, C::BK, C::BN, S::LDW>(Ws + slot * W_ELEMS, w, K, N,
                                          t * C::BK, n0, vec_w);
    }
    if (t == (steps > 0 ? steps - 1 : 0))
      load_tile<float, C::BM, C::BN, C::BN>(Ns, noise, M, N, m0, n0, vec_n);
    cp_async_commit();
  };
  // the three bf16 pieces of w tile t (an f32 w) into piece set t % 2
  auto split = [&](int t) {
    if constexpr (S::SPLIT) {
      const float* w_s = reinterpret_cast<const float*>(Ws) +
                         (t % C::STAGES) * W_ELEMS;
      bf16* p = Ps + (t & 1) * 3 * P_ELEMS;
      constexpr int Q = C::BK * C::BN / 4;
      static_assert(Q % THREADS == 0, "");
#pragma unroll
      for (int e = 0; e < Q / THREADS; ++e) {
        const int idx = threadIdx.x + e * THREADS;
        const int r = idx / (C::BN / 4), c = (idx % (C::BN / 4)) * 4;
        split4(w_s + r * C::LDF + c, p, P_ELEMS, r * C::LDH + c);
      }
    }
  };

  FragC sum[C::FM][C::FN], part[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(sum[i][j], 0.0f);

#pragma unroll
  for (int t = 0; t < C::D; ++t) load(t);
  cp_async_wait<C::D - 1>();  // tile 0
  __syncthreads();
  if (steps > 0) split(0);

  for (int t = 0; t < steps; ++t) {
    // Tile t + 1 has landed (D - 2 younger groups may be in flight). The
    // barrier publishes it and the pieces of tile t, and retires every
    // read of tile t - 1, whose slot and piece set are reused below.
    cp_async_wait<C::D - 2>();
    __syncthreads();
    load(t + C::D);

    const bf16* a_s = As + (t % C::STAGES) * A_ELEMS;
    const bf16* pieces[NP];  // smallest first: lo, mid, hi
    if constexpr (S::SPLIT) {
      const bf16* p = Ps + (t & 1) * 3 * P_ELEMS;
      pieces[0] = p + 2 * P_ELEMS;
      pieces[1] = p + P_ELEMS;
      pieces[2] = p;
    } else {
      pieces[0] = reinterpret_cast<const bf16*>(Ws) + (t % C::STAGES) * W_ELEMS;
    }

    FragA a[C::KF][C::FM];
#pragma unroll
    for (int kk = 0; kk < C::KF; ++kk)
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(
            a[kk][i], a_s + (wm * C::FM + i) * 16 * C::LDA + kk * 16, C::LDA);
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(part[i][j], 0.0f);
    // smallest pieces first, so the partial sum is small while they add in
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int kk = 0; kk < C::KF; ++kk)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) {
          FragB b;
          wmma::load_matrix_sync(
              b, pieces[p] + kk * 16 * C::LDH + (wn * C::FN + j) * 16, C::LDH);
#pragma unroll
          for (int i = 0; i < C::FM; ++i)
            wmma::mma_sync(part[i][j], a[kk][i], b, part[i][j]);
        }
    }
    // the next tile's pieces, while the tensor cores work on this one
    if (t + 1 < steps) split(t + 1);
    // promote this step's partial sums with IEEE f32 adds
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
#pragma unroll
        for (int e = 0; e < sum[i][j].num_elements; ++e)
          sum[i][j].x[e] = __fadd_rn(sum[i][j].x[e], part[i][j].x[e]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes now hold the sums; the noise is in

  // epilogue: each warp stages its sums in shared memory, then walks them
  // row by row, so that out is written in whole rows of its tile
  constexpr int WR = C::FM * 16, WC = C::FN * 16;
  float* sums = reinterpret_cast<float*>(smem) + warp * WR * WC;
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
      wmma::store_matrix_sync(sums + i * 16 * WC + j * 16, sum[i][j], WC,
                              wmma::mem_row_major);
  __syncwarp();
  const int mb = m0 + wm * WR, nb = n0 + wn * WC;
#pragma unroll 4
  for (int e = lane; e < WR * WC; e += 32) {
    const int m = mb + e / WC, n = nb + e % WC;
    if (m >= M || n >= N) continue;
    const float z = Ns[(m - m0) * C::BN + (n - n0)];
    float y = __fmul_rn(sums[e], io.inp_res);
    y = __fadd_rn(y, __fmul_rn(io.out_noise, z));
    y = clamp(y, -io.out_bound, io.out_bound);
    y = __fmul_rn(rintf(__fmul_rn(y, io.inv_out_res)), io.out_res);
    store(out + (size_t)m * N + n, __fmul_rn(y, s[m]));
  }
}

template <typename TX, typename TW, typename C>
cudaError_t launch_tiles(const bf16* codes, const void* w, const float* s,
                         const float* noise, void* out, int M, int N, int K,
                         const IO& io, cudaStream_t stream) {
  using S = Smem<C, TW>;
  auto kern = mvm_kernel<TX, TW, C>;
  // the shared-memory limit is raised once per device, on the first call,
  // so a later call can be captured in a CUDA graph
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const bool vec_a = K % 8 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const bool vec_w = N % (16 / sizeof(TW)) == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_n = N % 4 == 0 && reinterpret_cast<uintptr_t>(noise) % 16 == 0;
  // row tiles on x (up to 2^31 - 1 blocks), column tiles on y (65535)
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
  kern<<<grid, THREADS, S::BYTES, stream>>>(
      codes, static_cast<const TW*>(w), s, noise, static_cast<TX*>(out), M, N,
      K, vec_a, vec_w, vec_n, io);
  return cudaGetLastError();
}

using Big = Tiles<128, 128, 32, 2, 3>;   // warp 64 x 32: 4 x 2 fragments
using Mid = Tiles<64, 64, 32, 2, 3>;     // warp 32 x 16: 2 x 1
using Small = Tiles<32, 64, 32, 2, 4>;   // warp 16 x 16: 1 x 1

long long blocks(int M, int N, int bm, int bn) {
  return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// The largest tile that still gives every SM a block; else the smallest.
template <typename TX, typename TW>
cudaError_t launch(const bf16* codes, const void* w, const float* s,
                   const float* noise, void* out, int M, int N, int K,
                   const IO& io, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (blocks(M, N, Big::BM, Big::BN) >= SMS)
    return launch_tiles<TX, TW, Big>(codes, w, s, noise, out, M, N, K, io,
                                     stream);
  if (blocks(M, N, Mid::BM, Mid::BN) >= SMS)
    return launch_tiles<TX, TW, Mid>(codes, w, s, noise, out, M, N, K, io,
                                     stream);
  return launch_tiles<TX, TW, Small>(codes, w, s, noise, out, M, N, K, io,
                                     stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each returns a cudaError_t
// (0 = ok).

// codes (M, K) bf16 and s (M, 1) f32 from x (M, K).
extern "C" int dac_codes_launch(int x_dtype, const void* x, void* codes,
                                void* s, int M, int K, float inv_inp_res,
                                float inp_bound, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((M + WARPS - 1) / WARPS);
  bf16* c = static_cast<bf16*>(codes);
  float* sf = static_cast<float*>(s);
  if (x_dtype == 0)
    dac_codes_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), c, sf, M, K, inv_inp_res, inp_bound);
  else if (x_dtype == 1)
    dac_codes_kernel<bf16><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(x), c, sf, M, K, inv_inp_res, inp_bound);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out (M, N) in out_dtype from the codes, s, w (K, N) and noise (M, N).
extern "C" int analog_mvm_launch(
    int out_dtype, int w_dtype, const void* codes, const void* w,
    const void* s, const void* noise, void* out, int M, int N, int K,
    float inp_res, float out_res, float inv_out_res, float out_bound,
    float out_noise, void* stream) {
  const IO io{inp_res, out_res, inv_out_res, out_bound, out_noise};
  const bf16* c = static_cast<const bf16*>(codes);
  const float* sf = static_cast<const float*>(s);
  const float* nf = static_cast<const float*>(noise);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0 && w_dtype == 0)
    return launch<float, float>(c, w, sf, nf, out, M, N, K, io, st);
  if (out_dtype == 0 && w_dtype == 1)
    return launch<float, bf16>(c, w, sf, nf, out, M, N, K, io, st);
  if (out_dtype == 1 && w_dtype == 0)
    return launch<bf16, float>(c, w, sf, nf, out, M, N, K, io, st);
  if (out_dtype == 1 && w_dtype == 1)
    return launch<bf16, bf16>(c, w, sf, nf, out, M, N, K, io, st);
  return (int)cudaErrorInvalidValue;
}
