// K4 on Hopper: fused paged decode attention for absorbed MLA (multi-head
// latent attention: MiniCPM3, DeepSeek-V2) with the SoftmAP Alg.-1 softmax.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:248
// (paged_attention_mla, body _mla_kernel) behind the int_pallas_paged
// backend: the paged MLA decode of models/mla.py calls it through
// kernels/paged_attention/ops.py. The Alg.-1 arithmetic is alg1.cuh, the
// body K1 and K2 run too.
//
// For each slot s and each of its ROWS = T * H query rows (row t * H + h),
// against the head-shared latent pool c [NB, BS, R] and rope keys
// kr [NB, BS, DR]:
//   score[j] = (round_cdt(q_lat . c[j]) + round_cdt(q_rope . kr[j])) * scale
//              (each dot accumulated in f32, rounded to the compute dtype,
//              the two added in f32: the reference's "semi" rounding)
//   valid[j] = kpos <= qpos[t]
//   p        = Alg. 1 over the valid scores of the row, rounded to cdt
//   out      = round_cdt(sum_j p[j] c[j], f32 accumulation)   [R wide]
// where c[j], kr[j] come from pool block table[s, j / BS] at offset j % BS,
// and an entry outside [0, NB) is a zero tile that is never loaded.
//
// Bound on an H100: the latent row is both key and value, so per key a row
// costs 2 (R + DR) + 2 R f32 operations plus Alg. 1, while the pool is read
// once per slot and shared by all H heads: at minicpm3's width (H 40, R 256,
// DR 32) the f32 operations outside the tensor cores bound it, not the
// bytes.
//
// Design (simple first; no wgmma, TMA or split-row passes yet):
//   * one CTA of 256 threads per (slot, row tile): the wrapper picks the
//     tile (1, 2, 4, 8 or 16 rows, a template parameter) so that the
//     tile's score rows fit the card's opt-in shared memory and the grid
//     covers the SMs. Each row stays whole inside its CTA, so Alg. 1 runs
//     over full rows as in the TPU kernel (flash-style rescaling does not
//     hold for Alg. 1). Tiles of a slot re-read the slot's latent pages,
//     from L2 after the first;
//   * only the pages through the page of the tile's largest position are
//     visited: a masked position is out of the row max and adds 0 to the
//     sum, so leaving it out is exact; the TPU kernel walks all pages;
//   * scores: one thread per key position, the tile's rows in registers,
//     each dot summed in order over R (then DR) from 16-byte loads of the
//     key's latent row against q staged in shared memory as f32 (the same
//     address across a warp: a broadcast); the scores of the tile over the
//     span stay in dynamic shared memory, [tile, span] f32 (span <= NLOG *
//     BS);
//   * Alg. 1: one warp per row, in place in that buffer: fp max, M-bit
//     codes, integer max, exp codes, exact int64 sum clipped once,
//     division to P_out bits; probabilities rounded to cdt in place;
//   * PV: one thread per output column (R <= 512 = 2 x 256), the tile's
//     rows in registers, f32 sums over the span key by key, reading the
//     latent straight from the pool 16 keys at a time, rounded once to cdt.
// R and DR are multiples of 8 and the pools 16-byte aligned (the wrapper
// checks). Shared memory is tile * (R + DR + NLOG * BS) * 4 bytes. scores_out /
// probs_out ([S, ROWS, NLOG * BS] f32, may be null) take the scores and
// probabilities of the span for the chip smoke test's bitwise check of the
// Alg.-1 step; positions outside the span are left as the caller filled
// them.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "alg1.cuh"

// Shapes of one launch (mirrored by ctypes in
// repro_torch/kernels/paged_attention/ops.py:MlaShape).
struct MlaShape {
  int S;         // slots
  int rows;      // query rows per slot: T * heads
  int heads;     // query heads
  int T;         // query positions per slot
  int R;         // latent rank (<= 512, a multiple of 8)
  int DR;        // rope dim (<= 64, a multiple of 8)
  int NB;        // pool blocks
  int BS;        // tokens per block
  int NLOG;      // table entries per slot
  int row_tile;  // rows per CTA: 1, 2, 4, 8 or 16
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 2 * kThreads;  // PV: at most two columns a thread
constexpr int kMaxDr = 64;
constexpr int kPvChunk = 16;         // latent loads in flight per PV thread

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
// for the TILE query rows q + r * ldq (f32, shared memory).
template <int TILE, typename T>
__device__ __forceinline__ void dot_rows(const T* __restrict__ k, const float* q, int n,
                                         int ldq, float* acc) {
  for (int d0 = 0; d0 < n; d0 += 8) {
    float v[8];
    load8(k + d0, v);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      const float4 qa = *reinterpret_cast<const float4*>(q + r * ldq + d0);
      const float4 qb = *reinterpret_cast<const float4*>(q + r * ldq + d0 + 4);
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

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
paged_attention_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                           const T* __restrict__ c_pool, const T* __restrict__ kr_pool,
                           const int* __restrict__ table, const int* __restrict__ positions,
                           T* __restrict__ out, float* __restrict__ scores_out,
                           float* __restrict__ probs_out, MlaShape a, Alg1Consts c) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);

  const int n_tiles = (a.rows + TILE - 1) / TILE;
  const int s = blockIdx.x / n_tiles;
  const int r0 = (blockIdx.x % n_tiles) * TILE;
  const int nr = min(TILE, a.rows - r0);
  const int* trow = table + static_cast<size_t>(s) * a.NLOG;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  const int l_full = a.NLOG * a.BS;
  const int width = a.R + a.DR;

  // the live span: pages through the page of the tile's largest position
  int qmax = prow[r0 / a.heads];
  for (int r = 1; r < nr; ++r) qmax = max(qmax, prow[(r0 + r) / a.heads]);
  const int page_hi = qmax < 0 ? 0 : min(a.NLOG, qmax / a.BS + 1);
  const int span = page_hi * a.BS;

  float* qs = smem;                  // [TILE, R + DR], zero past the tile's rows
  float* sc = smem + TILE * width;   // [TILE, span]
  const size_t row0 = static_cast<size_t>(s) * a.rows + r0;
  for (int i = threadIdx.x; i < TILE * width; i += kThreads) {
    const int r = i / width, d = i % width;
    float v = 0.0f;
    if (r < nr)
      v = d < a.R ? to_f(q_lat[(row0 + r) * a.R + d])
                  : to_f(q_rope[(row0 + r) * a.DR + d - a.R]);
    qs[i] = v;
  }
  __syncthreads();

  // scores: one thread per key position, every row of the tile
  for (int j = threadIdx.x; j < span; j += kThreads) {
    const int ent = trow[j / a.BS];
    float lat[TILE], rope[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r) lat[r] = rope[r] = 0.0f;
    if (ent >= 0 && ent < a.NB) {  // a sentinel is a zero tile, never loaded
      const size_t tok = static_cast<size_t>(ent) * a.BS + j % a.BS;
      dot_rows<TILE>(c_pool + tok * a.R, qs, a.R, width, lat);
      dot_rows<TILE>(kr_pool + tok * a.DR, qs + a.R, a.DR, width, rope);
    }
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r < nr) sc[r * span + j] = (round_to<T>(lat[r]) + round_to<T>(rope[r])) * a.scale;
    }
  }
  __syncthreads();

  // Alg. 1: one warp per row, in place in sc
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int floor_code = -(1 << (c.M - 1));
  for (int r = warp; r < nr; r += kWarps) {
    const int qpos = prow[(r0 + r) / a.heads];
    float* row = sc + r * span;
    const size_t dbg = (row0 + r) * l_full;

    float m = ALG1_NEG_INF;
    for (int j = lane; j < span; j += 32) {
      if (scores_out != nullptr) scores_out[dbg + j] = row[j];
      if (j <= qpos) m = fmaxf(m, row[j]);
    }
    m = warp_reduce(m, Alg1MaxF());
    if (m <= ALG1_NEG_INF) m = 0.0f;  // fully masked row

    int vmax = floor_code;
    for (int j = lane; j < span; j += 32) {
      const int v = j <= qpos ? alg1_quantize(row[j], m, c) : floor_code;
      row[j] = __int_as_float(v);
      vmax = max(vmax, v);
    }
    vmax = warp_reduce(vmax, Alg1MaxI());

    long long sum = 0;
    for (int j = lane; j < span; j += 32) {
      const int va = j <= qpos ? alg1_exp(__float_as_int(row[j]) - vmax, c) : 0;
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

  // PV: one thread per latent column, the tile's rows in registers (rows
  // past nr compute on unused scratch and are not stored)
  T* ob = out + row0 * a.R;
  for (int col = threadIdx.x; col < a.R; col += kThreads) {
    float acc[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r) acc[r] = 0.0f;
    for (int pg = 0; pg < page_hi; ++pg) {
      const int ent = trow[pg];
      if (ent < 0 || ent >= a.NB) continue;  // zero tile
      const T* cp = c_pool + static_cast<size_t>(ent) * a.BS * a.R + col;
      // kPvChunk loads in flight, then the sums in key order
      for (int o0 = 0; o0 < a.BS; o0 += kPvChunk) {
        float v[kPvChunk];
#pragma unroll
        for (int i = 0; i < kPvChunk; ++i) {
          v[i] = o0 + i < a.BS ? to_f(cp[static_cast<size_t>(o0 + i) * a.R]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kPvChunk; ++i) {
          if (o0 + i >= a.BS) break;
          const float* pj = sc + pg * a.BS + o0 + i;
#pragma unroll
          for (int r = 0; r < TILE; ++r) acc[r] = fmaf(pj[r * span], v[i], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r < nr) ob[static_cast<size_t>(r) * a.R + col] = from_f<T>(acc[r]);
    }
  }
}

template <typename T>
using MlaKernel = void (*)(const T*, const T*, const T*, const T*, const int*, const int*, T*,
                           float*, float*, MlaShape, Alg1Consts);

constexpr int kTiles[] = {1, 2, 4, 8, 16};

template <typename T>
MlaKernel<T> kernel_for(int tile) {
  switch (tile) {
    case 1: return paged_attention_mla_kernel<T, 1>;
    case 2: return paged_attention_mla_kernel<T, 2>;
    case 4: return paged_attention_mla_kernel<T, 4>;
    case 8: return paged_attention_mla_kernel<T, 8>;
    case 16: return paged_attention_mla_kernel<T, 16>;
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
int launch(const void* q_lat, const void* q_rope, const void* c_pool, const void* kr_pool,
           const int* table, const int* positions, void* out, float* scores_out,
           float* probs_out, const MlaShape& a, const Alg1Consts& c, cudaStream_t stream) {
  int limit = 0;
  const int rc = smem_limit<T>(&limit);
  if (rc != 0) return rc;
  const MlaKernel<T> kernel = kernel_for<T>(a.row_tile);
  const size_t smem = static_cast<size_t>(a.row_tile) *
                      (a.R + a.DR + static_cast<size_t>(a.NLOG) * a.BS) * sizeof(float);
  if (kernel == nullptr || smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (a.rows + a.row_tile - 1) / a.row_tile;
  kernel<<<a.S * n_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(c_pool), static_cast<const T*>(kr_pool), table, positions,
      static_cast<T*>(out), scores_out, probs_out, a, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). dtype: 0
// bfloat16, 1 float32 (queries, both pools and out share it). The caller
// allocates `out` and checks shapes and alignment
// (ops.py:paged_attention_mla_rows).
extern "C" int paged_attention_mla_launch(const void* q_lat, const void* q_rope,
                                          const void* c_pool, const void* kr_pool,
                                          const int* table, const int* positions, void* out,
                                          float* scores_out, float* probs_out, int dtype,
                                          MlaShape a, Alg1Consts c, void* stream) {
  if (a.S < 1 || a.T < 1 || a.heads < 1 || a.rows != a.T * a.heads || a.R < 8 ||
      a.R > kMaxR || a.R % 8 != 0 || a.DR < 8 || a.DR > kMaxDr || a.DR % 8 != 0 ||
      a.NB < 1 || a.BS < 1 || a.NLOG < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q_lat, q_rope, c_pool, kr_pool, table, positions, out,
                                 scores_out, probs_out, a, c, st);
  if (dtype == 1)
    return launch<float>(q_lat, q_rope, c_pool, kr_pool, table, positions, out, scores_out,
                         probs_out, a, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) one launch may take on the current
// card, into *limit; returns a CUDA error code. dtype as above. The wrapper
// reads it to size the row tile and to refuse a row that cannot fit.
extern "C" int paged_attention_mla_smem_limit(int dtype, int* limit) {
  if (dtype == 0) return smem_limit<__nv_bfloat16>(limit);
  if (dtype == 1) return smem_limit<float>(limit);
  return static_cast<int>(cudaErrorInvalidValue);
}
