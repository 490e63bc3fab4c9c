// Chopped-EMA SP-tracking filter (paper eq. 12) with its two telemetry
// reductions, for Hopper (sm_90a).
//
// Replaces the TPU kernel `sp_filter_pallas`
// (src/repro/kernels/sp_filter.py:56, body `_kernel`). Element-wise over a
// contiguous range of any rank:
//   q_new = (1 - eta) q + eta p                      (written in q's dtype)
//   gp_sq = sum G_p(p)^2,  err_sq = sum (q_new - w_sp)^2   (float32)
// with the soft-bounds G and the closed-form symmetric point w_sp of
// `sp_filter_ref` (src/repro_torch/kernels/ref.py).
//
// Bound: memory. Per float32 element it reads q, p, gamma and rho (16 B)
// and writes q_new (4 B), for ~25 flops: 20 B an element at 3.35 TB/s,
// 26 us for Qwen2-0.5B's MLP tile (896, 4864). The five IEEE divisions an
// element make the arithmetic a large part of that time too, so loads have
// to stay in flight while the thread computes. What the design does:
// * One launch per call. Each block reduces its two sums to a partial pair
//   in the workspace and draws an integer ticket (an atomic add with
//   release and acquire order, which makes the partial visible first); the
//   block that draws the last ticket adds every partial in block order
//   through a fixed tree, writes the sums and puts the ticket back to 0.
//   A one-block call writes its sums directly. A small call pays one
//   launch, not two, and there are no float atomics: the sums are
//   bit-identical from run to run.
// * 16-byte loads. Where all five operands are aligned, a thread moves one
//   item of four elements per operand at a time (float4 for f32, 8 bytes
//   for bf16), and holds two rounds in registers: the next round's four
//   loads are in flight while the current round computes. The last
//   size % 4 elements go through scalar code in the last block, after its
//   vectors. Where any operand is not aligned (a view at a storage offset),
//   the same kernel walks its range element by element in the same way.
// * A grid that fills the card once: the host (kernels/sp_filter.py,
//   `launch_plan`) gives each of at most 4 blocks an SM (61 registers a
//   thread allow no more) a contiguous range of whole chunks of CHUNK
//   items, the ranges at most one chunk apart. Block count, ranges and
//   path depend on the size and the alignment alone, so the sum order does
//   too.
//
// Parity: the arithmetic is `sp_filter_ref` op for op, uncontracted (built
// with --fmad=false): true IEEE divisions by tau_min and tau_max (not the
// Pallas body's reciprocal multiplies), and 1 - eta and eta handed over as
// float32 by the host, as torch rounds Python scalars. q_new is bit-equal
// to the plain version; the sums differ from it only in summation order,
// which `sums_in_launch_order` (kernels/sp_filter.py) replays in torch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;  // items: the unit of the blocks' ranges

// Loads and stores of VEC consecutive elements as floats: one 16-byte
// (f32) or 8-byte (bf16) access for VEC = 4, a scalar access for VEC = 1.
template <typename T, int VEC>
struct Io;

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* __restrict__ p,
                                              int64_t i, float* v) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* __restrict__ p,
                                               int64_t i, const float* v) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(
      const __nv_bfloat16* __restrict__ p, int64_t i, float* v) {
    const uint2 x = reinterpret_cast<const uint2*>(p)[i];
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __bfloat162float(lo.x);
    v[1] = __bfloat162float(lo.y);
    v[2] = __bfloat162float(hi.x);
    v[3] = __bfloat162float(hi.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p,
                                               int64_t i, const float* v) {
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(v[0]);
    lo.y = __float2bfloat16_rn(v[1]);
    hi.x = __float2bfloat16_rn(v[2]);
    hi.y = __float2bfloat16_rn(v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&lo);
    x.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(p)[i] = x;
  }
};

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* __restrict__ p,
                                              int64_t i, float* v) {
    v[0] = p[i];
  }
  static __device__ __forceinline__ void store(float* __restrict__ p,
                                               int64_t i, const float* v) {
    p[i] = v[0];
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(
      const __nv_bfloat16* __restrict__ p, int64_t i, float* v) {
    v[0] = __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p,
                                               int64_t i, const float* v) {
    p[i] = __float2bfloat16_rn(v[0]);
  }
};

struct Params {
  float eta, one_minus_eta, tau_min, tau_max;
};

// One element: returns q_new and adds G_p(p)^2 and (q_new - w_sp)^2 into
// the thread's running sums, in the operation order of `sp_filter_ref`.
__device__ __forceinline__ float element(float qf, float pf, float gam,
                                         float rh, const Params& k, float& gp,
                                         float& err) {
  const float q_new = __fadd_rn(__fmul_rn(k.one_minus_eta, qf),
                                __fmul_rn(k.eta, pf));

  // G_p(p) of the soft-bounds response
  const float a_p = __fadd_rn(gam, rh);
  const float a_m = __fsub_rn(gam, rh);
  const float qp = __fmul_rn(a_p, __fsub_rn(1.0f, __fdiv_rn(pf, k.tau_max)));
  const float qm = __fmul_rn(a_m, __fadd_rn(1.0f, __fdiv_rn(pf, k.tau_min)));
  const float g = __fmul_rn(__fsub_rn(qm, qp), 0.5f);
  gp = __fadd_rn(gp, __fmul_rn(g, g));

  // SP tracking error against the closed-form symmetric point
  const float w_sp = __fdiv_rn(
      __fsub_rn(a_p, a_m),
      __fadd_rn(__fdiv_rn(a_p, k.tau_max), __fdiv_rn(a_m, k.tau_min)));
  const float d = __fsub_rn(q_new, w_sp);
  err = __fadd_rn(err, __fmul_rn(d, d));
  return q_new;
}

// One round of a thread's operands: one item of VEC elements each.
template <int VEC>
struct Round {
  float q[VEC], p[VEC], g[VEC], r[VEC];
};

template <typename TQ, typename TP, int VEC>
__device__ __forceinline__ void load_round(
    Round<VEC>& x, const TQ* __restrict__ q, const TP* __restrict__ p,
    const float* __restrict__ gamma, const float* __restrict__ rho,
    int64_t i) {
  Io<TQ, VEC>::load(q, i, x.q);
  Io<TP, VEC>::load(p, i, x.p);
  Io<float, VEC>::load(gamma, i, x.g);
  Io<float, VEC>::load(rho, i, x.r);
}

// Computes a loaded round element by element and stores it.
template <typename TQ, int VEC>
__device__ __forceinline__ void finish_round(const Round<VEC>& x,
                                             TQ* __restrict__ q_out,
                                             int64_t i, const Params& k,
                                             float& gp, float& err) {
  float out[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    out[j] = element(x.q[j], x.p[j], x.g[j], x.r[j], k, gp, err);
  Io<TQ, VEC>::store(q_out, i, out);
}

// Items [start, end) of VEC elements each: round r gives thread t item
// start + r * THREADS + t. Two rounds live in registers, so the next
// round's loads are in flight while the current one computes. The sum
// order is the rounds' order.
template <typename TQ, typename TP, int VEC>
__device__ __forceinline__ void run_range(
    const TQ* __restrict__ q, const TP* __restrict__ p,
    const float* __restrict__ gamma, const float* __restrict__ rho,
    TQ* __restrict__ q_out, int64_t start, int64_t end, const Params& k,
    float& gp, float& err) {
  Round<VEC> a, b;
  int64_t i = start + threadIdx.x;
  if (i < end) load_round<TQ, TP, VEC>(a, q, p, gamma, rho, i);
  for (; i < end; i += 2 * THREADS) {
    if (i + THREADS < end)
      load_round<TQ, TP, VEC>(b, q, p, gamma, rho, i + THREADS);
    finish_round<TQ, VEC>(a, q_out, i, k, gp, err);
    if (i + THREADS >= end) break;
    if (i + 2 * THREADS < end)
      load_round<TQ, TP, VEC>(a, q, p, gamma, rho, i + 2 * THREADS);
    finish_round<TQ, VEC>(b, q_out, i + THREADS, k, gp, err);
  }
}

// Sums a and b over the block in a fixed tree; thread 0 gets the totals.
// Callers separate two uses by a __syncthreads().
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

// Adds one to the ticket and returns its old value, with release order for
// this thread's earlier stores (its block's partials are visible to whoever
// draws a later ticket) and acquire order for what follows (the last block
// sees every partial). Lighter than __threadfence(), a full fence.
__device__ __forceinline__ unsigned int draw_ticket(unsigned int* ticket) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// `items` vectors of 4 (vector != 0) or single elements, cut into
// `chunks` chunks of CHUNK items; block b takes chunks
// [b * chunks / nb, (b + 1) * chunks / nb), so the blocks' ranges differ by
// at most one chunk. With vector != 0, the `tail` elements past 4 * items
// follow in the last block, one per thread. `partials` holds 2 floats per
// block; `ticket` is 0 at entry and at exit.
template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS, 4)
sp_filter_kernel(const TQ* __restrict__ q, const TP* __restrict__ p,
                 const float* __restrict__ gamma,
                 const float* __restrict__ rho, TQ* __restrict__ q_out,
                 float* partials, float* __restrict__ sums,
                 unsigned int* ticket, int64_t items, int64_t chunks,
                 int vector, int tail, Params k) {
  const int64_t b = blockIdx.x, nb = gridDim.x;
  const int64_t start = b * chunks / nb * CHUNK;  // <= items
  const int64_t stop = (b + 1) * chunks / nb * CHUNK;
  const int64_t end = stop < items ? stop : items;
  float gp = 0.0f, err = 0.0f;
  if (vector) {
    run_range<TQ, TP, 4>(q, p, gamma, rho, q_out, start, end, k, gp, err);
    if (b == nb - 1 && threadIdx.x < tail) {
      const int64_t i = 4 * items + threadIdx.x;
      float qf, pf, gam, rh;
      Io<TQ, 1>::load(q, i, &qf);
      Io<TP, 1>::load(p, i, &pf);
      Io<float, 1>::load(gamma, i, &gam);
      Io<float, 1>::load(rho, i, &rh);
      const float out = element(qf, pf, gam, rh, k, gp, err);
      Io<TQ, 1>::store(q_out, i, &out);
    }
  } else {
    run_range<TQ, TP, 1>(q, p, gamma, rho, q_out, start, end, k, gp, err);
  }

  block_sum2(gp, err);
  if (nb == 1) {  // the only block is the last: its partial is the sum
    if (threadIdx.x == 0) {
      sums[0] = gp;
      sums[1] = err;
    }
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[2 * b] = gp;
    partials[2 * b + 1] = err;
    last = draw_ticket(ticket) == (unsigned int)(nb - 1);
  }
  __syncthreads();
  if (!last) return;

  // The last block: thread t adds partials t, t + THREADS, ... in order
  // (read past L1: other blocks wrote them), then the block adds the
  // threads' sums in the same tree.
  gp = 0.0f;
  err = 0.0f;
  for (int64_t j = threadIdx.x; j < nb; j += THREADS) {
    gp = __fadd_rn(gp, __ldcg(partials + 2 * j));
    err = __fadd_rn(err, __ldcg(partials + 2 * j + 1));
  }
  block_sum2(gp, err);
  if (threadIdx.x == 0) {
    sums[0] = gp;
    sums[1] = err;
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* p, const float* gamma,
                   const float* rho, void* q_out, float* partials,
                   float* sums, unsigned int* ticket, int64_t items,
                   int64_t chunks, int blocks, int vector, int tail,
                   const Params& k, cudaStream_t stream) {
  if (blocks < 1 || tail < 0 || tail > 3 || (!vector && tail != 0))
    return cudaErrorInvalidValue;
  sp_filter_kernel<TQ, TP><<<blocks, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(p), gamma, rho,
      static_cast<TQ*>(q_out), partials, sums, ticket, items, chunks, vector,
      tail, k);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q_out has q's dtype. The launch
// plan (`items`, `chunks`, `blocks`, `vector`, `tail`) comes from
// `launch_plan` in kernels/sp_filter.py; `partials` holds 2 * blocks
// floats, `sums` receives (gp_sq, err_sq), and `ticket` is one unsigned
// int that is 0 before the launch (the kernel leaves it 0). Returns a
// cudaError_t (0 = ok).
extern "C" int sp_filter_launch(
    int q_dtype, int p_dtype, const void* q, const void* p, const void* gamma,
    const void* rho, void* q_out, void* partials, void* sums, void* ticket,
    int64_t items, int64_t chunks, int blocks, int vector, int tail,
    float eta, float one_minus_eta, float tau_min, float tau_max,
    void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* r = static_cast<const float*>(rho);
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(sums);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  const Params k{eta, one_minus_eta, tau_min, tau_max};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP_FILTER_LAUNCH(TQ, TP)                                           \
  launch<TQ, TP>(q, p, g, r, q_out, part, out, tk, items, chunks, blocks, \
                 vector, tail, k, s)
  if (q_dtype == 0 && p_dtype == 0) return SP_FILTER_LAUNCH(float, float);
  if (q_dtype == 0 && p_dtype == 1)
    return SP_FILTER_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && p_dtype == 0)
    return SP_FILTER_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 1 && p_dtype == 1)
    return SP_FILTER_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef SP_FILTER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
