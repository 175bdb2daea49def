// K3 on Hopper: fused prefill attention with the SoftmAP Alg.-1 softmax, a
// stand-alone op (the model does not call it, as the reference's model does
// not).
//
// Replaces the TPU kernel src/repro/kernels/int_attention/kernel.py:63
// (int_attention_kernel, body _kernel), behind
// kernels/int_attention/ops.py:int_attention_rows. The Alg.-1 arithmetic is
// alg1.cuh, the body K1, K2 and K4 run too.
//
// For each (batch x head bh) and each query row i of Sq, against kv row
// bh / group of Skv keys:
//   score[j] = (q_i . k_j, f32 accumulation, NOT rounded to the input
//              dtype) x d^-1/2 in f32
//   valid[j] = causal: j <= qpos and, with a window, qpos - j < window,
//              where qpos = i + Skv - Sq (right-aligned); else every key
//   p        = Alg. 1 over the valid scores of the full row
//   out      = sum_j round_in(p[j]) v_j, f32 accumulation, f32 out
//
// Bound on an H100: at a prefill of 512 tokens and d 128 the products are
// 2 x Sq x Skv x d operations per head, the bytes (q, k, v, f32 out) about
// 4 x Sq x d x 2-4 per head; the products on tensor cores would take less
// than the bytes, so the bytes bound it. This first kernel runs its
// products on the f32 ALUs, not the tensor cores: a redesign for speed
// (wgmma over the row tile) is later work.
//
// Design (simple first; the TPU tiling is not carried over: a TPU program
// holds 128 query rows x Skv f32 scores in 8 MB of VMEM, a CTA has 227 KB):
//   * one CTA of 256 threads per (bh, row tile): the wrapper picks the tile
//     (1, 2, 4, 8 or 16 rows, a template parameter) so that the tile's
//     score rows over all Skv keys fit the card's opt-in shared memory and
//     the grid covers the SMs; it raises when one row does not fit. Each
//     row stays whole inside its CTA, so Alg. 1 runs over full rows as in
//     the TPU kernel (flash-style rescaling does not hold for Alg. 1);
//   * causal: only keys up to the tile's largest qpos are visited (and,
//     with a window, from the tile's smallest qpos - window + 1): a masked
//     key is out of the row max and adds 0 to the sum, so leaving it out
//     is exact;
//   * scores: one thread per key, the tile's rows in registers, each dot
//     summed in order over d from 16-byte loads of the key row against q
//     staged in shared memory as f32 (the same address across a warp: a
//     broadcast); the tile's scores over the span stay in dynamic shared
//     memory, [tile, span] f32;
//   * Alg. 1: one warp per row, in place in that buffer; probabilities
//     rounded to the input dtype in place;
//   * PV: one thread per output column (d <= 256), the tile's rows in
//     registers, f32 sums over the span key by key, V read straight from
//     device memory 16 keys at a time.
// d is a multiple of 8 and q, k, v are 16-byte aligned (the wrapper
// checks). Shared memory is tile * (d + Skv) * 4 bytes. scores_out /
// probs_out ([BH, Sq, Skv] f32, may be null) take the scores and
// probabilities of the span for the chip smoke test's bitwise check of the
// Alg.-1 step; keys outside the span are left as the caller filled them.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "alg1.cuh"

// Shapes and options of one launch (mirrored by ctypes in
// repro_torch/kernels/int_attention/ops.py:AttnShape).
struct AttnShape {
  int BH;        // batch x query heads
  int group;     // query heads per kv head: kv row = bh / group
  int Sq;        // query rows
  int Skv;       // keys
  int D;         // head dim (<= 256, a multiple of 8)
  int causal;    // 1: right-aligned causal mask
  int window;    // with causal: sliding window (0: none)
  int row_tile;  // rows per CTA: 1, 2, 4, 8 or 16
  float scale;   // d^-1/2
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = kThreads;  // PV: one column a thread
constexpr int kPvChunk = 16;     // V loads in flight per PV thread

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

// Eight consecutive elements from a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* __restrict__ p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// acc[r] += q[r] . k over n elements (n a multiple of 8), in element order,
// for the TILE query rows q + r * n (f32, shared memory).
template <int TILE, typename T>
__device__ __forceinline__ void dot_rows(const T* __restrict__ k, const float* q, int n,
                                         float* acc) {
  for (int d0 = 0; d0 < n; d0 += 8) {
    float v[8];
    load8(k + d0, v);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      const float4 qa = *reinterpret_cast<const float4*>(q + r * n + d0);
      const float4 qb = *reinterpret_cast<const float4*>(q + r * n + d0 + 4);
      float x = acc[r];
      x = fmaf(qa.x, v[0], x); x = fmaf(qa.y, v[1], x);
      x = fmaf(qa.z, v[2], x); x = fmaf(qa.w, v[3], x);
      x = fmaf(qb.x, v[4], x); x = fmaf(qb.y, v[5], x);
      x = fmaf(qb.z, v[6], x); x = fmaf(qb.w, v[7], x);
      acc[r] = x;
    }
  }
}

// Reduction over the 32 lanes of a warp; every lane returns the result.
template <typename V, typename Op>
__device__ __forceinline__ V warp_reduce(V v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool valid_key(int kpos, int qpos, const AttnShape& a) {
  return !a.causal || (kpos <= qpos && (a.window == 0 || qpos - kpos < a.window));
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
int_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ scores_out, float* __restrict__ probs_out,
                     AttnShape a, Alg1Consts c) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);

  const int n_tiles = (a.Sq + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int r0 = (blockIdx.x % n_tiles) * TILE;
  const int nr = min(TILE, a.Sq - r0);
  const int shift = a.Skv - a.Sq;  // qpos of row i is i + shift
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.Skv;

  // the span of keys some row of the tile may attend
  int lo = 0, hi = a.Skv;
  if (a.causal) {
    hi = max(0, min(a.Skv, r0 + nr + shift));
    if (a.window) lo = min(hi, max(0, r0 + shift - a.window + 1));
  }
  const int span = hi - lo;

  float* qs = smem;               // [TILE, D], zero past the tile's rows
  float* sc = smem + TILE * a.D;  // [TILE, span]
  const size_t row0 = static_cast<size_t>(bh) * a.Sq + r0;
  for (int i = threadIdx.x; i < TILE * a.D; i += kThreads) {
    qs[i] = i / a.D < nr ? to_f(q[row0 * a.D + i]) : 0.0f;
  }
  __syncthreads();

  // scores: one thread per key, every row of the tile
  for (int j = threadIdx.x; j < span; j += kThreads) {
    float acc[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r) acc[r] = 0.0f;
    dot_rows<TILE>(k + (kv_row + lo + j) * a.D, qs, a.D, acc);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r < nr) sc[r * span + j] = __fmul_rn(acc[r], a.scale);
    }
  }
  __syncthreads();

  // Alg. 1: one warp per row, in place in sc
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int floor_code = -(1 << (c.M - 1));
  for (int r = warp; r < nr; r += kWarps) {
    const int qpos = r0 + r + shift;
    float* row = sc + r * span;
    const size_t dbg = (row0 + r) * a.Skv + lo;

    float m = ALG1_NEG_INF;
    for (int j = lane; j < span; j += 32) {
      if (scores_out != nullptr) scores_out[dbg + j] = row[j];
      if (valid_key(lo + j, qpos, a)) m = fmaxf(m, row[j]);
    }
    m = warp_reduce(m, Alg1MaxF());
    if (m <= ALG1_NEG_INF) m = 0.0f;  // fully masked row

    int vmax = floor_code;
    for (int j = lane; j < span; j += 32) {
      const int x = valid_key(lo + j, qpos, a) ? alg1_quantize(row[j], m, c) : floor_code;
      row[j] = __int_as_float(x);
      vmax = max(vmax, x);
    }
    vmax = warp_reduce(vmax, Alg1MaxI());

    long long sum = 0;
    for (int j = lane; j < span; j += 32) {
      const int va = valid_key(lo + j, qpos, a) ? alg1_exp(__float_as_int(row[j]) - vmax, c)
                                                : 0;
      row[j] = __int_as_float(va);
      sum += va;
    }
    sum = warp_reduce(sum, Alg1SumLL());
    const long long clipped = sum < c.sum_sat ? sum : c.sum_sat;
    const int total = clipped > 1 ? static_cast<int>(clipped) : 1;

    for (int j = lane; j < span; j += 32) {
      const float p = alg1_prob(__float_as_int(row[j]), total, c);
      if (probs_out != nullptr) probs_out[dbg + j] = p;
      row[j] = round_to<T>(p);
    }
  }
  __syncthreads();

  // PV: one thread per output column, the tile's rows in registers (rows
  // past nr compute on unused scratch and are not stored)
  float* ob = out + row0 * a.D;
  for (int col = threadIdx.x; col < a.D; col += kThreads) {
    float acc[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r) acc[r] = 0.0f;
    const T* vp = v + (kv_row + lo) * a.D + col;
    // kPvChunk loads in flight, then the sums in key order
    for (int j0 = 0; j0 < span; j0 += kPvChunk) {
      float x[kPvChunk];
#pragma unroll
      for (int i = 0; i < kPvChunk; ++i) {
        x[i] = j0 + i < span ? to_f(vp[static_cast<size_t>(j0 + i) * a.D]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPvChunk; ++i) {
        if (j0 + i >= span) break;
        const float* pj = sc + j0 + i;
#pragma unroll
        for (int r = 0; r < TILE; ++r) acc[r] = fmaf(pj[r * span], x[i], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r < nr) ob[static_cast<size_t>(r) * a.D + col] = acc[r];
    }
  }
}

template <typename T>
using AttnKernel = void (*)(const T*, const T*, const T*, float*, float*, float*, AttnShape,
                            Alg1Consts);

constexpr int kTiles[] = {1, 2, 4, 8, 16};

template <typename T>
AttnKernel<T> kernel_for(int tile) {
  switch (tile) {
    case 1: return int_attention_kernel<T, 1>;
    case 2: return int_attention_kernel<T, 2>;
    case 4: return int_attention_kernel<T, 4>;
    case 8: return int_attention_kernel<T, 8>;
    case 16: return int_attention_kernel<T, 16>;
    default: return nullptr;
  }
}

// The dynamic shared memory the kernels for T may take on this card: the
// opt-in limit less the largest static scratch. The first call raises
// every tile's limit to it.
template <typename T>
int smem_limit(int* limit) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, optin = 0, static_max = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int tile : kTiles) {
      cudaFuncAttributes attr{};
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel_for<T>(tile));
      static_max = max(static_max, static_cast<int>(attr.sharedSizeBytes));
    }
    const int lim = optin - static_max;
    for (int tile : kTiles) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel_for<T>(tile),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    cached = lim;
  }
  *limit = cached;
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, float* out, float* scores_out,
           float* probs_out, const AttnShape& a, const Alg1Consts& c, cudaStream_t stream) {
  int limit = 0;
  const int rc = smem_limit<T>(&limit);
  if (rc != 0) return rc;
  const AttnKernel<T> kernel = kernel_for<T>(a.row_tile);
  const size_t smem =
      static_cast<size_t>(a.row_tile) * (a.D + static_cast<size_t>(a.Skv)) * sizeof(float);
  if (kernel == nullptr || smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (a.Sq + a.row_tile - 1) / a.row_tile;
  kernel<<<a.BH * n_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out,
      scores_out, probs_out, a, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). dtype: 0
// bfloat16, 1 float32 (q, k and v share it; out is f32). The caller
// allocates `out` and checks shapes and alignment
// (ops.py:int_attention_rows).
extern "C" int int_attention_launch(const void* q, const void* k, const void* v, float* out,
                                    float* scores_out, float* probs_out, int dtype,
                                    AttnShape a, Alg1Consts c, void* stream) {
  if (a.BH < 1 || a.group < 1 || a.BH % a.group != 0 || a.Sq < 1 || a.Skv < 1 || a.D < 8 ||
      a.D > kMaxD || a.D % 8 != 0 || a.window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, out, scores_out, probs_out, a, c, st);
  if (dtype == 1) return launch<float>(q, k, v, out, scores_out, probs_out, a, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) one launch may take on the current
// card, into *limit; returns a CUDA error code. dtype as above. The wrapper
// reads it to size the row tile and to refuse a row that cannot fit.
extern "C" int int_attention_smem_limit(int dtype, int* limit) {
  if (dtype == 0) return smem_limit<__nv_bfloat16>(limit);
  if (dtype == 1) return smem_limit<float>(limit);
  return static_cast<int>(cudaErrorInvalidValue);
}
