// K2 on Hopper: fused paged decode attention with the SoftmAP Alg.-1
// softmax, dense / GQA layout, bf16 / f32 or int8 pools.
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
// scale per (block, offset, head) from k_scale / v_scale [NB, BS, KV]; a
// sentinel page loads neither codes nor scales.
//
// Bound on an H100: memory. Each K and V row a query needs is read once
// (int8 pools: a byte a value plus 4 bytes of scale per key and head); q,
// out and the table are small. Per key and row the work is two D-long dots
// and a few tens of integer operations, far under the ALU rate at decode
// (ROWS = group x T <= ~40). The TPU kernel walks a row's pages in order on
// one core and keeps the whole row's scores in VMEM; carried over, that
// gave one CTA per (slot, head) - 128 CTAs on 132 SMs at the serve shape -
// and a context capped by shared memory.
//
// Design: each row is split over CTAs in exact Alg.-1 passes (no online
// rescaling: Alg. 1 requantizes against the true row max, see the DESIGN
// NOTE of the TPU kernel). Only the pages holding some row's valid position
// are visited (the span, from the page of min(qpos) - window + 1 to the
// page of max(qpos)); a masked key is out of the row max and adds 0 to the
// sum, so leaving the others out is exact. The span is cut into chunks of
// a.chunk_pages pages (ref.py:k2_split_plan), planned for the decode step's
// rows (group): a verify block of T queries is cut at the same page
// boundaries as T single-query steps. A CTA takes the rows of its chunk in
// a.row_group rows (ref.py:k2_row_group: all of them while their score tile
// fits the plan's budget, else a group of rows under the same chunk; rows
// never interact, so grouping changes no bit). One CTA per (chunk, head and
// row group, slot), in launches on one stream:
//   1. scores: q staged as f32; the chunk's K rows come in 64-key stages by
//      16-byte cp.async into a double-buffered ring (int8 codes too, with
//      their scales, then dequantized in shared memory sixteen codes a
//      thread); four lanes per dot. The scores go to an f32 scratch [S, KV,
//      ROWS, NLOG * BS], each row's max over its valid keys to [S, KV, NC,
//      ROWS].
//   2. sums: the row max is the max of the chunk maxima (order-free, so
//      bitwise the whole row's); the integer max is the code of the row max,
//      alg1_quantize(m, m) = 0 (quantize is monotone, so this equals the max
//      over the valid codes); each chunk's exact int64 sum of exp codes goes
//      to [S, KV, NC, ROWS]. Rows of at most kSumsHereScores scores skip
//      this launch: launch 3 sums the span itself, which costs less than a
//      launch at decode.
//   3. PV: total = max(min(sum, sum_sat), 1), exact in any order; the
//      chunk's codes become probabilities rounded to cdt; the chunk's V rows
//      come in as K did, started before the kernel waits for the one before
//      it; each output column sums p * v in f32 in key order from 0, giving
//      an f32 partial [S, KV, NC, ROWS, Dv]. The CTA that finishes last (an
//      atomic ticket per (slot, head, row group), reset by launch 1) adds the partials
//      in chunk order from 0 and rounds once to cdt.
// Launches 2 and 3 are programmatic dependent launches: their CTAs start
// while the launch before runs and wait in griddepcontrol.wait. No float
// atomics: the same call gives the same bits run after run. The wrapper
// allocates the scratch (paged_attention_scratch_bytes); nothing here
// allocates. Shared memory grows with a row group x chunk keys, which the
// plan bounds; the context is bounded by the scratch alone.
// scores_out / probs_out ([S, KV, ROWS, NLOG * BS] f32, may be null) take
// the scores and probabilities of the span for the chip smoke test's
// bitwise check of the Alg.-1 step; positions outside the span are left as
// the caller filled them.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "alg1.cuh"
#include "paged_common.cuh"

// Shapes and options of one launch (mirrored by ctypes in
// repro_torch/kernels/paged_attention/ops.py:PagedShape).
struct PagedShape {
  int S;            // slots
  int KV;           // kv heads
  int rows;         // query rows per (slot, head): T * group
  int group;        // query heads per kv head
  int T;            // query positions per slot
  int D;            // head dim of q and k (<= 256)
  int Dv;           // head dim of v (<= 256)
  int NB;           // pool blocks
  int BS;           // tokens per block
  int NLOG;         // table entries per slot
  int window;       // sliding window (0: none)
  int scores_bf16;  // scores dtype: 1 bfloat16, 0 float32
  int quant;        // 1: int8 pools with f32 scales
  int chunk_pages;  // pages per chunk (one CTA each)
  int row_group;    // rows of a chunk one CTA takes (<= rows)
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageKeys = 64;      // keys per cp.async stage
constexpr int kLanesPerDot = 4;     // kThreads == kStageKeys * kLanesPerDot
constexpr int kMaxD = 256;
// CTAs of launches 1 and 3 an SM should hold at once (caps registers at 40)
constexpr int kMinBlocks = 6;
// Rows whose whole table holds at most this many (row, key) scores are
// summed in launch 3 itself (each CTA over the span) and skip launch 2.
constexpr int kSumsHereScores = 8192;
static_assert(kThreads == kStageKeys * kLanesPerDot, "one (key, lane) per thread");

__device__ __forceinline__ bool valid_pos(int kpos, int qpos, int window) {
  return kpos <= qpos && (window == 0 || kpos > qpos - window);
}

// ------------------------------------------------------------ layout

// The scratch one call needs, carved from one buffer the wrapper allocates.
struct Scratch {
  float* scores;      // [S, KV, ROWS, NLOG * BS] scores
  float* cmax;        // [S, KV, NC, ROWS] chunk max over valid keys
  long long* csum;    // [S, KV, NC, ROWS] chunk sum of exp codes
  float* part;        // [S, KV, NC, ROWS, Dv] chunk PV partials
  int* ticket;        // [S, KV, NG] chunks of launch 3 finished
};

__host__ __device__ __forceinline__ int n_chunks(const PagedShape& a) {
  return (a.NLOG + a.chunk_pages - 1) / a.chunk_pages;
}

// Row groups of a (slot, head): the grid's y is head * NG + group.
__host__ __device__ __forceinline__ int n_groups(const PagedShape& a) {
  return (a.rows + a.row_group - 1) / a.row_group;
}

// The (slot, head) and the rows [r0, r0 + nr) of this CTA.
struct Rows {
  int h, grp, r0, nr;
};
__device__ __forceinline__ Rows cta_rows(const PagedShape& a) {
  const int ng = n_groups(a);
  const int h = blockIdx.y / ng, grp = blockIdx.y - h * ng;
  const int r0 = grp * a.row_group;
  return {h, grp, r0, min(a.row_group, a.rows - r0)};
}

// Byte offsets of the scratch regions (256-byte aligned); returns the size.
__host__ __device__ inline size_t scratch_layout(const PagedShape& a, size_t off[5]) {
  const size_t sh = static_cast<size_t>(a.S) * a.KV;
  const size_t nc = static_cast<size_t>(n_chunks(a));
  const size_t sizes[5] = {sh * a.rows * a.NLOG * a.BS * 4, sh * nc * a.rows * 4,
                           sh * nc * a.rows * 8, sh * nc * a.rows * a.Dv * 4,
                           sh * n_groups(a) * 4};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at = round_up(at + sizes[i], 256);
  }
  return at;
}

Scratch carve(const PagedShape& a, void* base) {
  size_t off[5];
  scratch_layout(a, off);
  char* b = static_cast<char*>(base);
  return {reinterpret_cast<float*>(b + off[0]), reinterpret_cast<float*>(b + off[1]),
          reinterpret_cast<long long*>(b + off[2]), reinterpret_cast<float*>(b + off[3]),
          reinterpret_cast<int*>(b + off[4])};
}

// Shared memory of the ring that stages `width` pool values per key: the
// raw pool rows (two buffers, a padded row stride so that four lanes of two
// neighbouring keys read distinct banks), and for int8 pools the scales and
// one dequantized tile in the compute dtype.
struct Ring {
  int stride_p;  // bytes per key row of the raw ring
  int stride_t;  // bytes per key row of the dequantized tile
  size_t raw, scales, tile, bytes;
};

__host__ __device__ inline Ring ring_layout(int width, int esz_p, int esz_t, bool quant) {
  Ring r{};
  // int8 rows are read 16 bytes a thread along the row: no padding needed
  r.stride_p = quant ? static_cast<int>(round_up(width, 16))
                     : static_cast<int>(round_up(static_cast<size_t>(width) * esz_p, 128) + 64);
  r.stride_t = static_cast<int>(round_up(static_cast<size_t>(width) * esz_t, 128) + 64);
  r.raw = 2 * static_cast<size_t>(kStageKeys) * r.stride_p;
  r.scales = quant ? 2 * kStageKeys * sizeof(float) : 0;
  r.tile = quant ? static_cast<size_t>(kStageKeys) * r.stride_t : 0;
  r.bytes = r.raw + r.scales + r.tile;
  return r;
}

// Per-row statistics in shared memory (RowStats): the row max, the integer
// row max, the sum.
__host__ __device__ inline size_t row_stats_bytes(int rows) {
  return 2 * round_up(static_cast<size_t>(rows) * 4, 16) +
         round_up(static_cast<size_t>(rows) * 8, 16);
}

// Launch 1: q [RG, D] f32, chunk scores [RG, chunk keys] f32, ring (RG: a
// row group).
__host__ __device__ inline size_t scores_smem(const PagedShape& a, int esz_p, int esz_t) {
  const size_t ck = static_cast<size_t>(a.chunk_pages) * a.BS;
  return round_up(static_cast<size_t>(a.row_group) * a.D * 4, 16) +
         round_up(static_cast<size_t>(a.row_group) * ck * 4, 16) +
         ring_layout(a.D, esz_p, esz_t, a.quant).bytes;
}

// Launch 3: row statistics, totals [RG] int, probabilities [RG, chunk keys] f32,
// accumulators [RG, Dv] f32, ring.
__host__ __device__ inline size_t pv_smem(const PagedShape& a, int esz_p, int esz_t) {
  const size_t ck = static_cast<size_t>(a.chunk_pages) * a.BS;
  const size_t rg = static_cast<size_t>(a.row_group);
  return row_stats_bytes(a.row_group) + round_up(rg * 4, 16) + round_up(rg * ck * 4, 16) +
         round_up(rg * a.Dv * 4, 16) +
         ring_layout(a.Dv, esz_p, esz_t, a.quant).bytes;
}

// ------------------------------------------------------------ helpers

// The live span of slot s: pages [lo, hi) holding some row's valid position.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span live_span(const int* prow, const PagedShape& a) {
  int qmax = prow[0], qmin = prow[0];
  for (int t = 1; t < a.T; ++t) {
    qmax = max(qmax, prow[t]);
    qmin = min(qmin, prow[t]);
  }
  const int hi = qmax < 0 ? 0 : min(a.NLOG, qmax / a.BS + 1);
  const int lo = a.window ? min(max(0, qmin - a.window + 1) / a.BS, hi) : 0;
  return {lo, hi};
}

// Start one stage: keys [kb, kb + n) of the chunk starting at key k0, each a
// row of `width` pool values at head h, into ring buffer `buf`; int8 pools
// also bring their scales. Sentinel pages are zero-filled, never loaded.
template <typename P>
__device__ __forceinline__ void load_stage(const P* __restrict__ pool,
                                            const float* __restrict__ scales,
                                            const int* __restrict__ trow, const PagedShape& a,
                                            int h, int width, int k0, int kb, int n,
                                            unsigned char* raw, float* sscale, const Ring& rg) {
  const int pieces = width * static_cast<int>(sizeof(P)) / 16;
  for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
    const int j = i / pieces, pc = i - j * pieces;
    const int kpos = k0 + kb + j;
    const int ent = trow[kpos / a.BS];
    unsigned char* dst = raw + static_cast<size_t>(j) * rg.stride_p + pc * 16;
    if (ent >= 0 && ent < a.NB) {
      const size_t tok = (static_cast<size_t>(ent) * a.BS + kpos % a.BS) * a.KV + h;
      cp_async16(dst, reinterpret_cast<const unsigned char*>(pool + tok * width) + pc * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  if (scales != nullptr) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int kpos = k0 + kb + j;
      const int ent = trow[kpos / a.BS];
      if (ent >= 0 && ent < a.NB) {
        cp_async4(sscale + j,
                  scales + (static_cast<size_t>(ent) * a.BS + kpos % a.BS) * a.KV + h);
      } else {
        sscale[j] = 0.0f;
      }
    }
  }
}

// Sixteen f32 values stored as T at a 16-byte aligned `dst`.
__device__ __forceinline__ void store16(float* dst, const float (&f)[16]) {
#pragma unroll
  for (int u = 0; u < 16; u += 4)
    *reinterpret_cast<float4*>(dst + u) = make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float (&f)[16]) {
  unsigned w[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * u], f[2 * u + 1]);
    w[u] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

// An int8 stage as compute-dtype values: each code times its scale (one
// f32 multiply, rounded to T) into the tile, sixteen codes per thread.
template <typename T>
__device__ __forceinline__ const unsigned char* dequant_stage(const unsigned char* raw,
                                                              const float* sscale,
                                                              unsigned char* tile, int width,
                                                              int n, const Ring& rg) {
  const int pieces = width / 16;
  for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
    const int j = i / pieces, pc = i - j * pieces;
    const int4 c = *reinterpret_cast<const int4*>(raw + static_cast<size_t>(j) * rg.stride_p +
                                                  pc * 16);
    const int w[4] = {c.x, c.y, c.z, c.w};
    const float sc = sscale[j];
    float f[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      f[u] = __fmul_rn(static_cast<float>(static_cast<int8_t>(w[u >> 2] >> (8 * (u & 3)))), sc);
    store16(reinterpret_cast<T*>(tile + static_cast<size_t>(j) * rg.stride_t) + pc * 16, f);
  }
  __syncthreads();
  return tile;
}

// One 16-byte piece of a key row against the matching q values (f32).
__device__ __forceinline__ float dot_piece(const float* k, const float* q, float acc) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  acc = fmaf(qv.x, kv.x, acc);
  acc = fmaf(qv.y, kv.y, acc);
  acc = fmaf(qv.z, kv.z, acc);
  return fmaf(qv.w, kv.w, acc);
}
__device__ __forceinline__ float dot_piece(const __nv_bfloat16* k, const float* q, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  float2 f = __bfloat1622float2(k2[0]);
  acc = fmaf(q0.x, f.x, acc);
  acc = fmaf(q0.y, f.y, acc);
  f = __bfloat1622float2(k2[1]);
  acc = fmaf(q0.z, f.x, acc);
  acc = fmaf(q0.w, f.y, acc);
  f = __bfloat1622float2(k2[2]);
  acc = fmaf(q1.x, f.x, acc);
  acc = fmaf(q1.y, f.y, acc);
  f = __bfloat1622float2(k2[3]);
  acc = fmaf(q1.z, f.x, acc);
  return fmaf(q1.w, f.y, acc);
}

// The stage's rows as compute-dtype values: the ring buffer itself for a
// T pool, the dequantized tile for an int8 pool.
template <typename T, typename P>
__device__ __forceinline__ const unsigned char* values_of(const unsigned char* raw,
                                                          const float* sscale,
                                                          unsigned char* tile, int width,
                                                          int n, const Ring& rg) {
  if constexpr (std::is_same<P, int8_t>::value) {
    return dequant_stage<T>(raw, sscale, tile, width, n, rg);
  } else {
    return raw;
  }
}

// ------------------------------------------------------------ row statistics

// Per row of the CTA's rows [r0, r0 + nr) of (slot, head), in shared memory
// at local index r - r0: the guarded row max (the max of the chunk maxima,
// order-free), the integer row max (the code of the row max: 0 unless the
// row is fully masked, since quantize is monotone) and a zeroed exact sum.
struct RowStats {
  float* m;
  int* vmax;
  unsigned long long* sum;
};

__device__ __forceinline__ RowStats row_stats(unsigned char* at, const Scratch& w,
                                              const PagedShape& a, size_t sh, int n_live,
                                              const Alg1Consts& cst, const Rows& rw) {
  const size_t r4 = round_up(static_cast<size_t>(a.row_group) * 4, 16);
  RowStats st{reinterpret_cast<float*>(at), reinterpret_cast<int*>(at + r4),
              reinterpret_cast<unsigned long long*>(at + 2 * r4)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nc = n_chunks(a);
  for (int r = warp; r < rw.nr; r += kWarps) {
    float m = ALG1_NEG_INF;
    for (int cc = lane; cc < n_live; cc += 32)
      m = fmaxf(m, w.cmax[(sh * nc + cc) * a.rows + rw.r0 + r]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) {
      const float mu = m <= ALG1_NEG_INF ? 0.0f : m;  // fully masked row
      st.m[r] = mu;
      st.vmax[r] = alg1_quantize(m, mu, cst);
      st.sum[r] = 0;
    }
  }
  __syncthreads();
  return st;
}

// The exp code of the score of local row r (row r0 + r) at key position
// kpos (0 if masked).
__device__ __forceinline__ int exp_code(float x, int r, int kpos, const int* prow,
                                        const PagedShape& a, const RowStats& st,
                                        const Alg1Consts& cst, int r0) {
  return valid_pos(kpos, prow[(r0 + r) / a.group], a.window)
             ? alg1_exp(alg1_quantize(x, st.m[r], cst) - st.vmax[r], cst)
             : 0;
}

// Adds the exp codes of keys [k0, k0 + nk) of each of the CTA's rows into
// st.sum (integer: exact in any order): all threads over the keys of a
// row, a warp sum, one shared atomic per warp. `scores` is the (slot,
// head)'s [ROWS, l_full]. The codes of keys [c0, c0 + cn) also go to
// own[r * ck + key - c0] (as int bits, r local) when `own` is set. Ends
// with a barrier.
__device__ __forceinline__ void add_exp_sums(const float* scores, int l_full, int k0, int nk,
                                             const int* prow, const PagedShape& a,
                                             const RowStats& st, const Alg1Consts& cst,
                                             const Rows& rw, float* own = nullptr, int c0 = 0,
                                             int cn = 0, int ck = 0) {
  for (int r = 0; r < rw.nr; ++r) {
    const float* row = scores + static_cast<size_t>(rw.r0 + r) * l_full + k0;
    unsigned long long acc = 0;
#pragma unroll 4
    for (int jj = threadIdx.x; jj < nk; jj += kThreads) {
      const int va = exp_code(row[jj], r, k0 + jj, prow, a, st, cst, rw.r0);
      acc += va;
      const int o = k0 + jj - c0;
      if (own != nullptr && o >= 0 && o < cn) own[r * ck + o] = __int_as_float(va);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((threadIdx.x & 31) == 0 && acc != 0) atomicAdd(st.sum + r, acc);
  }
  __syncthreads();
}

// ------------------------------------------------------------ launch 1: scores

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k2_scores(const T* __restrict__ q, const P* __restrict__ k_pool,
          const float* __restrict__ k_scale, const int* __restrict__ table,
          const int* __restrict__ positions, float* __restrict__ scores_out, Scratch w,
          PagedShape a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, s = blockIdx.z;
  const Rows rw = cta_rows(a);
  const int h = rw.h;
  const size_t sh = static_cast<size_t>(s) * a.KV + h;
  const int* trow = table + static_cast<size_t>(s) * a.NLOG;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  start_next_grid();
  if (c == 0 && threadIdx.x == 0) w.ticket[sh * n_groups(a) + rw.grp] = 0;  // launch 3 counts from 0
  const Span sp = live_span(prow, a);
  const int pg0 = sp.lo + c * a.chunk_pages;
  if (pg0 >= sp.hi) return;
  const int ck = a.chunk_pages * a.BS;
  const int k0 = pg0 * a.BS, nk = min(pg0 + a.chunk_pages, sp.hi) * a.BS - k0;
  const int l_full = a.NLOG * a.BS, nc = n_chunks(a);

  const Ring rg = ring_layout(a.D, sizeof(P), sizeof(T), a.quant);
  float* qs = reinterpret_cast<float*>(smem);                                  // [nr, D]
  float* sct = reinterpret_cast<float*>(smem + round_up(size_t(a.row_group) * a.D * 4, 16));
  unsigned char* ring = reinterpret_cast<unsigned char*>(sct) +
                        round_up(size_t(a.row_group) * ck * 4, 16);
  float* sscale = reinterpret_cast<float*>(ring + rg.raw);
  unsigned char* tile = ring + rg.raw + rg.scales;

  const int nst = (nk + kStageKeys - 1) / kStageKeys;
  const size_t buf = static_cast<size_t>(kStageKeys) * rg.stride_p;
  for (int st = 0; st < 2; ++st) {
    if (st < nst)
      load_stage(k_pool, a.quant ? k_scale : nullptr, trow, a, h, a.D, k0, st * kStageKeys,
                  min(kStageKeys, nk - st * kStageKeys), ring + st * buf,
                  sscale + st * kStageKeys, rg);
    cp_async_commit();
  }
  const T* qb = q + (sh * a.rows + rw.r0) * a.D;
  for (int i = threadIdx.x; i < rw.nr * a.D; i += kThreads) qs[i] = to_f(qb[i]);

  constexpr int kPiece = 16 / sizeof(T);  // values per 16-byte piece
  const int pieces = a.D / kPiece;
  const int j = threadIdx.x / kLanesPerDot, part = threadIdx.x % kLanesPerDot;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait_one();
    __syncthreads();
    const int kb = st * kStageKeys, n = min(kStageKeys, nk - kb);
    const unsigned char* kt = values_of<T, P>(ring + (st & 1) * buf,
                                              sscale + (st & 1) * kStageKeys, tile, a.D, n, rg);
    const int stride = a.quant ? rg.stride_t : rg.stride_p;
    const T* krow = reinterpret_cast<const T*>(kt + static_cast<size_t>(j) * stride);
    for (int r = 0; r < rw.nr; ++r) {
      const float* qr = qs + r * a.D;
      float acc = 0.0f;
      for (int pc = part; pc < pieces; pc += kLanesPerDot)
        acc = dot_piece(krow + pc * kPiece, qr + pc * kPiece, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0 && j < n) {
        float x = round_to<T>(acc);
        x = a.scores_bf16 ? round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(x) * a.scale)
                          : x * a.scale;
        sct[r * ck + kb + j] = x;
      }
    }
    __syncthreads();
    if (st + 2 < nst)
      load_stage(k_pool, a.quant ? k_scale : nullptr, trow, a, h, a.D, k0,
                  (st + 2) * kStageKeys, min(kStageKeys, nk - (st + 2) * kStageKeys),
                  ring + (st & 1) * buf, sscale + (st & 1) * kStageKeys, rg);
    cp_async_commit();
  }

  // the scores to the scratch (and the debug rows), each row's chunk max
  for (int i = threadIdx.x; i < rw.nr * nk; i += kThreads) {
    const int r = i / nk, jj = i - r * nk;
    const size_t at = (sh * a.rows + rw.r0 + r) * l_full + k0 + jj;
    const float x = sct[r * ck + jj];
    w.scores[at] = x;
    if (scores_out != nullptr) scores_out[at] = x;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rw.nr; r += kWarps) {
    const int qpos = prow[(rw.r0 + r) / a.group];
    float m = ALG1_NEG_INF;
    for (int jj = lane; jj < nk; jj += 32)
      if (valid_pos(k0 + jj, qpos, a.window)) m = fmaxf(m, sct[r * ck + jj]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) w.cmax[(sh * nc + c) * a.rows + rw.r0 + r] = m;
  }
}

// ------------------------------------------------------------ launch 2: sums

// Each chunk's exact sum of exp codes per row (rows whose whole span is
// short skip this launch: launch 3 sums them itself).
__global__ void __launch_bounds__(kThreads)
k2_sums(const int* __restrict__ positions, Scratch w, PagedShape a, Alg1Consts cst) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, s = blockIdx.z;
  const Rows rw = cta_rows(a);
  const size_t sh = static_cast<size_t>(s) * a.KV + rw.h;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  start_next_grid();
  wait_previous_grid();
  const Span sp = live_span(prow, a);
  const int pg0 = sp.lo + c * a.chunk_pages;
  if (pg0 >= sp.hi) return;
  const int k0 = pg0 * a.BS, nk = min(pg0 + a.chunk_pages, sp.hi) * a.BS - k0;
  const int l_full = a.NLOG * a.BS;
  const int n_live = (sp.hi - sp.lo + a.chunk_pages - 1) / a.chunk_pages;
  const RowStats st = row_stats(smem, w, a, sh, n_live, cst, rw);
  add_exp_sums(w.scores + sh * a.rows * l_full, l_full, k0, nk, prow, a, st, cst, rw);
  for (int r = threadIdx.x; r < rw.nr; r += kThreads)
    w.csum[(sh * n_chunks(a) + c) * a.rows + rw.r0 + r] = static_cast<long long>(st.sum[r]);
}

// ------------------------------------------------------------ launch 3: PV

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k2_pv(const P* __restrict__ v_pool, const float* __restrict__ v_scale,
      const int* __restrict__ table, const int* __restrict__ positions, T* __restrict__ out,
      float* __restrict__ probs_out, Scratch w, PagedShape a, Alg1Consts cst,
      int sums_here) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int c = blockIdx.x, s = blockIdx.z;
  const Rows rw = cta_rows(a);
  const int h = rw.h;
  const size_t sh = static_cast<size_t>(s) * a.KV + h;
  const int* trow = table + static_cast<size_t>(s) * a.NLOG;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  const Span sp = live_span(prow, a);
  const int n_out = rw.nr * a.Dv;   // this CTA's outputs: rows [r0, r0 + nr)
  const size_t n_all = static_cast<size_t>(a.rows) * a.Dv;
  T* ob = out + sh * n_all + static_cast<size_t>(rw.r0) * a.Dv;
  if (sp.lo >= sp.hi) {  // no live page: the sum is empty
    wait_previous_grid();
    if (c == 0)
      for (int i = threadIdx.x; i < n_out; i += kThreads) ob[i] = from_f<T>(0.0f);
    return;
  }
  const int pg0 = sp.lo + c * a.chunk_pages;
  if (pg0 >= sp.hi) return;
  const int ck = a.chunk_pages * a.BS;
  const int k0 = pg0 * a.BS, nk = min(pg0 + a.chunk_pages, sp.hi) * a.BS - k0;
  const int l_full = a.NLOG * a.BS, nc = n_chunks(a);
  const int n_live = (sp.hi - sp.lo + a.chunk_pages - 1) / a.chunk_pages;

  const Ring rg = ring_layout(a.Dv, sizeof(P), sizeof(T), a.quant);
  unsigned char* stats = smem;
  int* tot = reinterpret_cast<int*>(smem + row_stats_bytes(a.row_group));      // [nr]
  float* pt = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tot) +
                                       round_up(size_t(a.row_group) * 4, 16));  // [nr, ck]
  float* acc = pt + round_up(size_t(a.row_group) * ck * 4, 16) / 4;             // [nr, Dv]
  unsigned char* ring = reinterpret_cast<unsigned char*>(acc) +
                        round_up(size_t(a.row_group) * a.Dv * 4, 16);
  float* sscale = reinterpret_cast<float*>(ring + rg.raw);
  unsigned char* tile = ring + rg.raw + rg.scales;

  // the V loads start first, under the sums and probabilities
  const int nst = (nk + kStageKeys - 1) / kStageKeys;
  const size_t buf = static_cast<size_t>(kStageKeys) * rg.stride_p;
  for (int st = 0; st < 2; ++st) {
    if (st < nst)
      load_stage(v_pool, a.quant ? v_scale : nullptr, trow, a, h, a.Dv, k0,
                  st * kStageKeys, min(kStageKeys, nk - st * kStageKeys), ring + st * buf,
                  sscale + st * kStageKeys, rg);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < n_out; i += kThreads) acc[i] = 0.0f;
  wait_previous_grid();  // launch 1's scores, or launch 2's sums

  const float* scores = w.scores + sh * a.rows * l_full;
  const RowStats st = row_stats(stats, w, a, sh, n_live, cst, rw);
  if (sums_here) {
    // the whole span's sums, keeping this chunk's codes in pt
    add_exp_sums(scores, l_full, sp.lo * a.BS, (sp.hi - sp.lo) * a.BS, prow, a, st, cst, rw,
                 pt, k0, nk, ck);
  } else {
    for (int r = threadIdx.x; r < rw.nr; r += kThreads) {
      long long sum = 0;
      for (int cc = 0; cc < n_live; ++cc) sum += w.csum[(sh * nc + cc) * a.rows + rw.r0 + r];
      st.sum[r] = static_cast<unsigned long long>(sum);
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rw.nr; r += kThreads) {
    const long long sum = static_cast<long long>(st.sum[r]);
    const long long clipped = sum < cst.sum_sat ? sum : cst.sum_sat;
    tot[r] = clipped > 1 ? static_cast<int>(clipped) : 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rw.nr * nk; i += kThreads) {
    const int r = i / nk, jj = i - r * nk;
    const int va = sums_here
                       ? __float_as_int(pt[r * ck + jj])
                       : exp_code(scores[static_cast<size_t>(rw.r0 + r) * l_full + k0 + jj], r,
                                  k0 + jj, prow, a, st, cst, rw.r0);
    const float p = alg1_prob(va, tot[r], cst);
    if (probs_out != nullptr) probs_out[(sh * a.rows + rw.r0 + r) * l_full + k0 + jj] = p;
    pt[r * ck + jj] = round_to<T>(p);
  }

  for (int st = 0; st < nst; ++st) {
    cp_async_wait_one();
    __syncthreads();
    const int kb = st * kStageKeys, n = min(kStageKeys, nk - kb);
    const unsigned char* vt = values_of<T, P>(ring + (st & 1) * buf,
                                              sscale + (st & 1) * kStageKeys, tile, a.Dv, n, rg);
    const int stride = a.quant ? rg.stride_t : rg.stride_p;
    for (int i = threadIdx.x; i < n_out; i += kThreads) {
      const int r = i / a.Dv, dv = i - r * a.Dv;
      const float* pr = pt + r * ck + kb;
      float x = acc[i];
      for (int jj = 0; jj < n; ++jj) {
        const T* vrow = reinterpret_cast<const T*>(vt + static_cast<size_t>(jj) * stride);
        x = fmaf(pr[jj], to_f(vrow[dv]), x);
      }
      acc[i] = x;
    }
    __syncthreads();
    if (st + 2 < nst)
      load_stage(v_pool, a.quant ? v_scale : nullptr, trow, a, h, a.Dv, k0,
                  (st + 2) * kStageKeys, min(kStageKeys, nk - (st + 2) * kStageKeys),
                  ring + (st & 1) * buf, sscale + (st & 1) * kStageKeys, rg);
    cp_async_commit();
  }

  // this chunk's partial of the CTA's rows; the last chunk of (slot, head,
  // row group) to finish adds them in chunk order and rounds once
  float* part = w.part + sh * nc * n_all + static_cast<size_t>(rw.r0) * a.Dv;
  for (int i = threadIdx.x; i < n_out; i += kThreads)
    part[static_cast<size_t>(c) * n_all + i] = acc[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(w.ticket + sh * n_groups(a) + rw.grp, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // kOuts outputs a thread, kBatch chunks at a time: the loads are
  // independent, each output's adds stay in chunk order
  constexpr int kBatch = 8, kOuts = 2;
  for (int i0 = threadIdx.x; i0 < n_out; i0 += kOuts * kThreads) {
    float x[kOuts] = {};
    for (int c0 = 0; c0 < n_live; c0 += kBatch) {
      float v[kOuts][kBatch];
#pragma unroll
      for (int o = 0; o < kOuts; ++o)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + o * kThreads;
          v[o][u] = (i < n_out && c0 + u < n_live)
                        ? __ldcg(part + static_cast<size_t>(c0 + u) * n_all + i)
                        : 0.0f;
        }
#pragma unroll
      for (int o = 0; o < kOuts; ++o)
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (c0 + u < n_live) x[o] += v[o][u];
    }
#pragma unroll
    for (int o = 0; o < kOuts; ++o)
      if (i0 + o * kThreads < n_out) ob[i0 + o * kThreads] = from_f<T>(x[o]);
  }
}

// ------------------------------------------------------------ host

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int* table, const int* positions, void* out,
           float* scores_out, float* probs_out, void* scratch, const PagedShape& a,
           const Alg1Consts& c, cudaStream_t stream) {
  static int allowed_scores = 48 * 1024, allowed_pv = 48 * 1024;
  int optin = 0;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t sm1 = scores_smem(a, sizeof(P), sizeof(T));
  const size_t sm2 = row_stats_bytes(a.row_group);
  const size_t sm3 = pv_smem(a, sizeof(P), sizeof(T));
  if (sm1 > static_cast<size_t>(optin) || sm3 > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(k2_scores<T, P>, sm1, &allowed_scores);
  if (err == cudaSuccess) err = allow_smem(k2_pv<T, P>, sm3, &allowed_pv);
  if (err != cudaSuccess) return static_cast<int>(err);
  // launch 3 sums the exp codes itself for short rows: no launch 2
  const int sums_here = static_cast<size_t>(a.rows) * a.NLOG * a.BS <= kSumsHereScores;
  const Scratch w = carve(a, scratch);
  const dim3 grid(n_chunks(a), a.KV * n_groups(a), a.S);
  k2_scores<T, P><<<grid, kThreads, sm1, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool), k_scale, table, positions,
      scores_out, w, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // launches 2 and 3 may start early (programmatic dependent launch) and
  // wait in the kernel: launch 3 starts its V loads before it waits
  cudaLaunchAttribute early{};
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  if (!sums_here) {
    cfg.dynamicSmemBytes = sm2;
    err = cudaLaunchKernelEx(&cfg, k2_sums, positions, w, a, c);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cfg.dynamicSmemBytes = sm3;
  err = cudaLaunchKernelEx(&cfg, k2_pv<T, P>, static_cast<const P*>(v_pool), v_scale, table,
                           positions, static_cast<T*>(out), probs_out, w, a, c, sums_here);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Bytes of scratch one launch of shape `a` needs (the wrapper allocates it).
extern "C" size_t paged_attention_scratch_bytes(PagedShape a) {
  size_t off[5];
  return scratch_layout(a, off);
}

// Launch on `stream`; returns a CUDA error code (0 on success). dtype: 0
// bfloat16, 1 float32 (q and out share it; so do both pools unless a.quant,
// when they hold int8 codes and k_scale / v_scale their f32 scales, else
// null). `scratch` holds paged_attention_scratch_bytes(a) bytes. The caller
// allocates `out` and checks shapes and 16-byte row alignment
// (ops.py:paged_attention_rows).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const float* k_scale, const float* v_scale,
                                      const int* table, const int* positions, void* out,
                                      float* scores_out, float* probs_out, void* scratch,
                                      int dtype, PagedShape a, Alg1Consts c, void* stream) {
  if (a.S < 1 || a.KV < 1 || a.rows < 1 || a.T < 1 || a.rows != a.T * a.group || a.D < 1 ||
      a.D > kMaxD || a.Dv < 1 || a.Dv > kMaxD || a.NB < 1 || a.BS < 1 || a.NLOG < 1 ||
      a.chunk_pages < 1 || a.row_group < 1 || a.row_group > a.rows || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.quant && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return a.quant ? launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table,
                                                   positions, out, scores_out, probs_out,
                                                   scratch, a, c, st)
                   : launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                                          table, positions, out, scores_out,
                                                          probs_out, scratch, a, c, st);
  if (dtype == 1)
    return a.quant ? launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table,
                                           positions, out, scores_out, probs_out, scratch, a,
                                           c, st)
                   : launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, table, positions,
                                          out, scores_out, probs_out, scratch, a, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
