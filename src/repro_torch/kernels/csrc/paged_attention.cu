// K2 on Hopper: fused paged decode attention with the SoftmAP Alg.-1
// softmax, dense / GQA layout.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:145
// (paged_attention_dense, body _dense_kernel) behind the int_pallas_paged
// backend: the paged decode sites of models/attention.py call it through
// kernels/paged_attention/ops.py. The Alg.-1 arithmetic is alg1.cuh, the
// body K1 runs too.
//
// For each (slot s, kv-head h) and each of its ROWS = T * group query rows
// (row t * group + g):
//   score[j] = round_cdt(q . k[j], f32 accumulation) -> scores dtype, x scale
//   valid[j] = kpos <= qpos[t]   (and kpos > qpos[t] - window when set)
//   p        = Alg. 1 over the valid scores of the row, rounded to cdt
//   out      = round_cdt(sum_j p[j] v[j], f32 accumulation)
// where k[j], v[j] come from pool block table[s, j / BS] at offset j % BS,
// and an entry outside [0, NB) is a zero tile that is never loaded. An int8
// pool (the int8 KV cache, kv_quant) is dequantized on load as the TPU
// kernel's _page_tile does: round_cdt(float(code) * scale), one f32
// multiply (never fused into an FMA) rounded to nearest-even, with one f32
// scale per (block, offset, head) from k_scale / v_scale [NB, BS, KV];
// a sentinel page loads neither codes nor scales. The dequantized values
// equal the plain version's kv_dequantize bit for bit, and everything after
// them is the bf16/f32 kernel unchanged.
//
// Bound on an H100: memory. Per (slot, head) the live K and V pages are
// read once (int8 pools: 1 byte a value plus 4 bytes of scale per key and
// head, about half the bf16 bytes at D 128); q, out and the table are
// small. The work per key is one D-long dot and, per row, a few tens of
// integer operations — far under the ALU rate at decode (ROWS = 1..group).
//
// Design (simple first; no wgmma, TMA or split-row passes yet):
//   * one CTA of 256 threads per (slot, kv-head): grid S * KV;
//   * only the pages holding some row's valid positions are visited: from
//     the page of min(qpos) - window + 1 (0 without a window) to the page
//     of max(qpos). A masked position is out of the row max and adds 0 to
//     the sum, so leaving it out is exact; the TPU kernel walks all pages;
//   * scores: one warp per key position, lanes across D, q staged in shared
//     memory as f32; the scores of all rows over the span stay in dynamic
//     shared memory, [ROWS, span] f32 (span <= NLOG * BS);
//   * Alg. 1 per row in that buffer, in place: fp max, M-bit codes, integer
//     max, exp codes, exact int64 sum clipped once, division to P_out bits;
//     the probabilities are rounded to the compute dtype in place;
//   * PV: one thread per (row, output column), f32 sum over the span,
//     reading V straight from the pool, rounded once to the compute dtype.
// Shared memory is ROWS * NLOG * BS * 4 + ROWS * D * 4 bytes, at most the
// card's opt-in limit (227 KB): a 32768-token row at ROWS 1 fits.
// scores_out / probs_out ([S, KV, ROWS, NLOG * BS] f32, may be null) take
// the scores and probabilities of the span for the chip smoke test's
// bitwise check of the Alg.-1 step; positions outside the span are left as
// the caller filled them.
#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "alg1.cuh"

// Shapes and options of one launch (mirrored by ctypes in
// repro_torch/kernels/paged_attention/ops.py:PagedShape).
struct PagedShape {
  int S;            // slots
  int KV;           // kv heads
  int rows;         // query rows per (slot, head): T * group
  int group;        // query heads per kv head
  int T;            // query positions per slot
  int D;            // head dim of q and k (<= 256)
  int Dv;           // head dim of v
  int NB;           // pool blocks
  int BS;           // tokens per block
  int NLOG;         // table entries per slot
  int window;       // sliding window (0: none)
  int scores_bf16;  // scores dtype: 1 bfloat16, 0 float32
  int quant;        // 1: int8 pools with f32 scales
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;  // D <= 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to nearest-even in T and widened back to f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ bool valid_pos(int kpos, int qpos, int window) {
  return kpos <= qpos && (window == 0 || kpos > qpos - window);
}

// One pool value as f32 in the compute dtype T: a T element as it is, or an
// int8 code times its scale (one f32 multiply, rounded to T).
template <typename T>
__device__ __forceinline__ float pool_value(const T* __restrict__ pool, size_t i,
                                            const float* __restrict__, size_t) {
  return to_f(pool[i]);
}
template <typename T>
__device__ __forceinline__ float pool_value(const int8_t* __restrict__ pool, size_t i,
                                            const float* __restrict__ scale, size_t si) {
  return round_to<T>(__fmul_rn(static_cast<float>(pool[i]), scale[si]));
}

// T: compute dtype of q and out; P: pool element, T or int8_t (then
// k_scale / v_scale are read, else they are null).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       const int* __restrict__ positions, T* __restrict__ out,
                       float* __restrict__ scores_out, float* __restrict__ probs_out,
                       PagedShape a, Alg1Consts c) {
  extern __shared__ float smem[];
  __shared__ float s_max_f[32];
  __shared__ int s_max_i[32];
  __shared__ long long s_sum[32];

  const int s = blockIdx.x / a.KV, h = blockIdx.x % a.KV;
  const int* trow = table + static_cast<size_t>(s) * a.NLOG;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  const int l_full = a.NLOG * a.BS;
  const size_t head = static_cast<size_t>(s) * a.KV + h;

  // the live span: pages holding some row's valid positions
  int qmax = prow[0], qmin = prow[0];
  for (int t = 1; t < a.T; ++t) {
    qmax = max(qmax, prow[t]);
    qmin = min(qmin, prow[t]);
  }
  const int page_hi = qmax < 0 ? 0 : min(a.NLOG, qmax / a.BS + 1);
  const int page_lo = a.window ? min(max(0, qmin - a.window + 1) / a.BS, page_hi) : 0;
  const int base = page_lo * a.BS;
  const int span = (page_hi - page_lo) * a.BS;

  float* sc = smem;                                          // [rows, span]
  float* qs = smem + static_cast<size_t>(a.rows) * l_full;   // [rows, D]
  const T* qb = q + head * a.rows * a.D;
  for (int i = threadIdx.x; i < a.rows * a.D; i += kThreads) qs[i] = to_f(qb[i]);
  __syncthreads();

  // scores: one warp per key position, lanes across D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < span; j += kWarps) {
    const int kpos = base + j;
    const int ent = trow[kpos / a.BS];
    const bool live = ent >= 0 && ent < a.NB;
    float kr[kMaxDPerLane];
    const size_t tok = (static_cast<size_t>(live ? ent : 0) * a.BS + kpos % a.BS) * a.KV + h;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      kr[i] = (live && d < a.D) ? pool_value<T>(k_pool, tok * a.D + d, k_scale, tok) : 0.0f;
    }
    for (int r = 0; r < a.rows; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < a.D) acc = fmaf(qs[r * a.D + d], kr[i], acc);
      }
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        float x = round_to<T>(acc);
        x = a.scores_bf16 ? round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(x) * a.scale)
                          : x * a.scale;
        sc[static_cast<size_t>(r) * span + j] = x;
      }
    }
  }
  __syncthreads();

  // Alg. 1 per row, in place in sc (each thread keeps to its own columns
  // between the block reductions)
  const int floor_code = -(1 << (c.M - 1));
  for (int r = 0; r < a.rows; ++r) {
    const int qpos = prow[r / a.group];
    float* row = sc + static_cast<size_t>(r) * span;
    const size_t dbg = (head * a.rows + r) * l_full + base;

    float m = ALG1_NEG_INF;
    for (int j = threadIdx.x; j < span; j += kThreads) {
      if (scores_out != nullptr) scores_out[dbg + j] = row[j];
      if (valid_pos(base + j, qpos, a.window)) m = fmaxf(m, row[j]);
    }
    m = alg1_block_reduce(m, Alg1MaxF(), s_max_f);
    if (m <= ALG1_NEG_INF) m = 0.0f;  // fully masked row

    int vmax = floor_code;
    for (int j = threadIdx.x; j < span; j += kThreads) {
      const int v = valid_pos(base + j, qpos, a.window) ? alg1_quantize(row[j], m, c) : floor_code;
      row[j] = __int_as_float(v);
      vmax = max(vmax, v);
    }
    vmax = alg1_block_reduce(vmax, Alg1MaxI(), s_max_i);

    long long sum = 0;
    for (int j = threadIdx.x; j < span; j += kThreads) {
      const int va = valid_pos(base + j, qpos, a.window)
                         ? alg1_exp(__float_as_int(row[j]) - vmax, c) : 0;
      row[j] = __int_as_float(va);
      sum += va;
    }
    sum = alg1_block_reduce(sum, Alg1SumLL(), s_sum);
    const long long clipped = sum < c.sum_sat ? sum : c.sum_sat;
    const int total = clipped > 1 ? static_cast<int>(clipped) : 1;

    for (int j = threadIdx.x; j < span; j += kThreads) {
      const float p = alg1_prob(__float_as_int(row[j]), total, c);
      if (probs_out != nullptr) probs_out[dbg + j] = p;
      row[j] = round_to<T>(p);
    }
  }
  __syncthreads();

  // PV: one thread per (row, output column), pages of the span in order
  T* ob = out + head * a.rows * a.Dv;
  for (int i = threadIdx.x; i < a.rows * a.Dv; i += kThreads) {
    const int r = i / a.Dv, dv = i % a.Dv;
    const float* pr = sc + static_cast<size_t>(r) * span;
    float acc = 0.0f;
    for (int pg = page_lo; pg < page_hi; ++pg) {
      const int ent = trow[pg];
      if (ent < 0 || ent >= a.NB) continue;  // zero tile
      const size_t tok0 = static_cast<size_t>(ent) * a.BS * a.KV + h;
      const float* pp = pr + (pg - page_lo) * a.BS;
      for (int o = 0; o < a.BS; ++o) {
        const size_t tok = tok0 + static_cast<size_t>(o) * a.KV;
        acc = fmaf(pp[o], pool_value<T>(v_pool, tok * a.Dv + dv, v_scale, tok), acc);
      }
    }
    ob[i] = from_f<T>(acc);
  }
}

// The dynamic shared memory the kernels for T (bf16/f32 and int8 pools)
// may take on this card: the opt-in limit less the larger static scratch.
// The first call raises both kernels' limits to it.
template <typename T>
int smem_limit(int* limit) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes plain{}, quant{};
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&plain, paged_attention_kernel<T, T>);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&quant, paged_attention_kernel<T, int8_t>);
    const int lim =
        optin - static_cast<int>(std::max(plain.sharedSizeBytes, quant.sharedSizeBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(paged_attention_kernel<T, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(paged_attention_kernel<T, int8_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached = lim;
  }
  *limit = cached;
  return 0;
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int* table, const int* positions, void* out,
           float* scores_out, float* probs_out, const PagedShape& a, const Alg1Consts& c,
           cudaStream_t stream) {
  int limit = 0;
  const int rc = smem_limit<T>(&limit);
  if (rc != 0) return rc;
  const size_t smem = (static_cast<size_t>(a.rows) * a.NLOG * a.BS +
                       static_cast<size_t>(a.rows) * a.D) * sizeof(float);
  if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.quant) {
    if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    paged_attention_kernel<T, int8_t><<<a.S * a.KV, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(k_pool),
        static_cast<const int8_t*>(v_pool), k_scale, v_scale, table, positions,
        static_cast<T*>(out), scores_out, probs_out, a, c);
  } else {
    paged_attention_kernel<T, T><<<a.S * a.KV, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        nullptr, nullptr, table, positions, static_cast<T*>(out), scores_out, probs_out, a, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). dtype: 0
// bfloat16, 1 float32 (q and out share it; so do both pools unless a.quant,
// when they hold int8 codes and k_scale / v_scale their f32 scales, else
// null). The caller allocates `out` and checks shapes
// (ops.py:paged_attention_rows).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const float* k_scale, const float* v_scale,
                                      const int* table, const int* positions, void* out,
                                      float* scores_out, float* probs_out, int dtype,
                                      PagedShape a, Alg1Consts c, void* stream) {
  if (a.S < 1 || a.KV < 1 || a.rows < 1 || a.T < 1 || a.rows != a.T * a.group ||
      a.D < 1 || a.D > 32 * kMaxDPerLane || a.Dv < 1 || a.NB < 1 || a.BS < 1 || a.NLOG < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, table, positions, out,
                                 scores_out, probs_out, a, c, st);
  if (dtype == 1)
    return launch<float>(q, k_pool, v_pool, k_scale, v_scale, table, positions, out,
                         scores_out, probs_out, a, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) one launch may take on the current
// card, into *limit; returns a CUDA error code. dtype as above. The wrapper
// reads it to refuse a launch that cannot fit with a readable error.
extern "C" int paged_attention_smem_limit(int dtype, int* limit) {
  if (dtype == 0) return smem_limit<__nv_bfloat16>(limit);
  if (dtype == 1) return smem_limit<float>(limit);
  return static_cast<int>(cudaErrorInvalidValue);
}
