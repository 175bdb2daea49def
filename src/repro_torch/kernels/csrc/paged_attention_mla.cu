// K4 on Hopper: fused paged decode attention for absorbed MLA (multi-head
// latent attention: MiniCPM3, DeepSeek-V2) with the SoftmAP Alg.-1 softmax.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:248
// (paged_attention_mla, body _mla_kernel) behind the int_pallas_paged
// backend: the paged MLA decode of models/mla.py calls it through
// kernels/paged_attention/ops.py. The Alg.-1 arithmetic is alg1.cuh, the
// body K1, K2 and K3 run too; the page loads and launch chaining are
// K2's (paged_common.cuh).
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
// Bound on an H100: bytes. The latent row is both key and value and all H
// heads of a slot share it, so the function reads each needed latent and
// rope row once: at minicpm3-4b's serve shape (S 8, H 40, R 256, DR 32,
// ~500 keys a slot) 2.3 MB, 0.00077 ms at 3.35 TB/s, while the products
// (2 (R + DR) + 2 R per row and key) take about 0.0005 ms at the bf16
// tensor-core peak. At decode sizes what the kernel pays is latency: the
// launches, a round trip of page loads, the combine. The whole-row design
// this replaces kept each row in one CTA (2 rows a CTA at the serve shape,
// so the 20 CTAs of a slot each re-read its pages), ran the dots on CUDA
// cores one key a thread, and capped the context by shared memory.
//
// Design: each row is split over CTAs in exact Alg.-1 passes, as K2
// (paged_attention.cu) splits its rows: no online rescaling, since Alg. 1
// requantizes against the true row max. Only pages [0, page of the slot's
// largest position] are visited (a masked key is out of the row max and
// adds 0 to the sum). That span is cut into chunks of a.chunk_pages pages
// (ref.py:k4_split_plan, sized so the grid covers the SMs and the combine
// stays short), and a slot's rows into head tiles of up to kTileRows rows.
// At decode the kernel pays latency, so every phase issues its loads before
// it needs them and keeps all threads on independent work. Three launches
// on one stream:
//   1. scores, one CTA per (chunk, head tile, slot): the tile's queries and
//      the chunk's latent and rope rows come by 16-byte cp.async, the rows
//      in stages of Stage<T>::kKeys keys through a double-buffered ring
//      (sentinel pages zero-filled, never loaded). bf16: both dots on
//      tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate), A = the
//      query tile by ldmatrix, B = the ring's key rows ([key][R] is B's
//      column-major layout, ldmatrix without .trans), one accumulator over
//      R and one over DR, each rounded to bf16, added in f32, scaled; the
//      (m tile, n tile) pairs of a stage spread over all warps. f32: one
//      thread per (row, key), each dot fmaf in element order (no TF32: it
//      would change the products). Scores go to an f32 scratch [S, ROWS,
//      NLOG * BS], each row's max over the chunk's valid keys to [S, NC,
//      ROWS] (an ordered-integer atomicMax in shared memory).
//   2. sums, one CTA per (chunk, head tile, slot), four threads a row over
//      every row of the tile at once: the row max is the max of the chunk
//      maxima (order-free, so bitwise the whole row's); the integer max is
//      the code of the row max (quantize is monotone); each chunk's exact
//      int64 sum of exp codes to [S, NC, ROWS]. Rows whose table holds at
//      most kSumsHereScores scores skip this launch: launch 3 sums the span
//      itself.
//   3. PV, one CTA per (chunk, (head tile, kPvCols-column group), slot):
//      the group's latent columns of the chunk come in as in launch 1,
//      issued before the kernel waits for the launch before it, each
//      stage's scores right after the wait, under the row statistics; the
//      stage's probabilities (total = max(min(sum, sum_sat), 1), exact in
//      any order; alg1_prob_fast) are rounded to cdt into a shared tile P
//      [rows, keys].
//      bf16: P V on tensor cores, A = P by ldmatrix, B = the latent rows by
//      ldmatrix.trans ([key][col] is B's row-major layout), a warp per
//      8-column n tile over every m tile of the head tile, accumulated over
//      the chunk's keys in order, 16 at a time. f32: a thread per (column,
//      row), fmaf key by key. This gives f32 partials [S, NC, ROWS, R]; the
//      CTA that finishes last among a (slot, head tile, column group)'s
//      chunks (an atomic ticket, reset by launch 1) adds them in chunk order
//      from 0 and rounds once to cdt.
// Launches 2 and 3 are programmatic dependent launches: their CTAs start
// while the launch before runs and wait in griddepcontrol.wait. No float
// atomics: the same call gives the same bits run after run. Nothing here
// allocates; the wrapper allocates the scratch
// (paged_attention_mla_scratch_bytes). Shared memory depends on R, DR and
// the head tile only, so the context is bounded by the scratch alone.
//
// Why mma.sync and not wgmma or TMA: a head tile holds 40 rows at
// minicpm3's width (a 64-row wgmma tile would pad a third of its rows, and
// at 4-16 rows the reference matrix's most of them), the stages are a few
// KB that 16-byte cp.async covers, and at decode the kernel is bound by
// latency, not by the tensor-core rate.
//
// Rounding of the tensor-core sums: the checks of chip_smoke.py do not
// assume round-to-nearest inside an mma; they bound each 16-deep step as
// fused sums that keep 24 bits of their largest addend and truncate
// (chip_smoke.py:MMA_UNIT).
//
// R and DR are multiples of 8 (padded with zeros to 16 in shared memory),
// R <= 512, DR <= 64, and the queries and pools 16-byte aligned (the
// wrapper checks).
// scores_out / probs_out ([S, ROWS, NLOG * BS] f32, may be null) take the
// scores and probabilities of the span for the chip smoke test's bitwise
// check of the Alg.-1 step; positions outside the span are left as the
// caller filled them.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "alg1.cuh"
#include "paged_common.cuh"
#include "tensor_core.cuh"

// Shapes of one launch (mirrored by ctypes in
// repro_torch/kernels/paged_attention/ops.py:MlaShape).
struct MlaShape {
  int S;            // slots
  int rows;         // query rows per slot: T * heads
  int heads;        // query heads
  int T;            // query positions per slot
  int R;            // latent rank (<= 512, a multiple of 8)
  int DR;           // rope dim (<= 64, a multiple of 8)
  int NB;           // pool blocks
  int BS;           // tokens per block
  int NLOG;         // table entries per slot
  int chunk_pages;  // pages per chunk (ref.py:k4_split_plan)
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;   // rows of a head tile: four m16 tiles
constexpr int kPvCols = 64;     // latent columns of a PV CTA: one n8 tile a warp
constexpr int kMaxR = 512;
constexpr int kMaxDr = 64;
// Rows whose head tile x table holds at most this many scores are summed
// in launch 3 itself (each CTA over the span) and skip launch 2.
constexpr int kSumsHereScores = 8192;
// Scores each thread loads at once before it computes their Alg.-1 codes.
constexpr int kLoadBatch = 8;
static_assert(kPvCols == 8 * kWarps, "one n8 tile of PV columns a warp");
static_assert(kThreads == 4 * kTileRows, "four threads a row for the row statistics");

// Keys per cp.async stage: two k16 steps of the bf16 PV product; f32 rows
// are twice as wide, so half as many keys keep deepseek-v2's width (R 512,
// DR 64) inside the card's shared memory.
template <typename T>
struct Stage {
  static constexpr int kKeys = sizeof(T) == 2 ? 32 : 16;
};

// ------------------------------------------------------------ layout

// The scratch one call needs, carved from one buffer the wrapper allocates.
struct Scratch {
  float* scores;    // [S, ROWS, NLOG * BS] scores
  float* cmax;      // [S, NC, ROWS] chunk max over valid keys
  long long* csum;  // [S, NC, ROWS] chunk sum of exp codes
  float* part;      // [S, NC, ROWS, R] chunk PV partials
  int* ticket;      // [S, tiles, groups] chunks of launch 3 finished
};

__host__ __device__ __forceinline__ int n_chunks(const MlaShape& a) {
  return (a.NLOG + a.chunk_pages - 1) / a.chunk_pages;
}
__host__ __device__ __forceinline__ int n_tiles(const MlaShape& a) {
  return (a.rows + kTileRows - 1) / kTileRows;
}
__host__ __device__ __forceinline__ int n_groups(const MlaShape& a) {
  return (a.R + kPvCols - 1) / kPvCols;
}
// rows of shared memory a head tile takes (a multiple of the m16 tile)
__host__ __device__ __forceinline__ int tile_cap(const MlaShape& a) {
  const int r = static_cast<int>(round_up(a.rows, 16));
  return r < kTileRows ? r : kTileRows;
}
// elements of a staged key or query row: [latent | 0 | rope | 0], each part
// padded to the k16 depth of the mma
__host__ __device__ __forceinline__ int qk_width(const MlaShape& a) {
  return static_cast<int>(round_up(a.R, 16) + round_up(a.DR, 16));
}
// bytes between staged rows: an odd number of 16-byte units, so the eight
// row addresses of an ldmatrix fall in distinct banks
template <typename T>
__host__ __device__ __forceinline__ int row_stride(int elems) {
  return static_cast<int>(round_up(static_cast<size_t>(elems) * sizeof(T), 32) + 16);
}

// Byte offsets of the scratch regions (256-byte aligned); returns the size.
__host__ __device__ inline size_t scratch_layout(const MlaShape& a, size_t off[5]) {
  const size_t sr = static_cast<size_t>(a.S) * a.rows;
  const size_t nc = static_cast<size_t>(n_chunks(a));
  const size_t sizes[5] = {sr * a.NLOG * a.BS * 4, sr * nc * 4, sr * nc * 8,
                           sr * nc * a.R * 4,
                           static_cast<size_t>(a.S) * n_tiles(a) * n_groups(a) * 4};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at = round_up(at + sizes[i], 256);
  }
  return at;
}

Scratch carve(const MlaShape& a, void* base) {
  size_t off[5];
  scratch_layout(a, off);
  char* b = static_cast<char*>(base);
  return {reinterpret_cast<float*>(b + off[0]), reinterpret_cast<float*>(b + off[1]),
          reinterpret_cast<long long*>(b + off[2]), reinterpret_cast<float*>(b + off[3]),
          reinterpret_cast<int*>(b + off[4])};
}

// Launch 1: the query tile [tile_cap, W] and the ring 2 x [kKeys, W], T;
// the chunk maxima [kTileRows] int.
template <typename T>
__host__ __device__ inline size_t scores_smem(const MlaShape& a) {
  const size_t st = row_stride<T>(qk_width(a));
  return (tile_cap(a) + 2 * static_cast<size_t>(Stage<T>::kKeys)) * st + kTileRows * 4;
}
// Launch 3: the row max and integer max (4 B) and the sum or total (8 B)
// [kTileRows] each; the scores 2 x [tile_cap, kKeys] f32; the probabilities
// P [tile_cap, kKeys] and the ring 2 x [kKeys, kPvCols], T.
template <typename T>
__host__ __device__ inline size_t pv_smem(const MlaShape& a) {
  constexpr int kk = Stage<T>::kKeys;
  return 4 * kTileRows * 4 + 2 * static_cast<size_t>(tile_cap(a)) * kk * 4 +
         static_cast<size_t>(tile_cap(a)) * row_stride<T>(kk) +
         2 * static_cast<size_t>(kk) * row_stride<T>(kPvCols);
}

// ------------------------------------------------------------ helpers

// Pages [0, hi) of slot s that hold some row's valid position.
__device__ __forceinline__ int live_hi(const int* prow, const MlaShape& a) {
  int qmax = prow[0];
  for (int t = 1; t < a.T; ++t) qmax = max(qmax, prow[t]);
  return qmax < 0 ? 0 : min(a.NLOG, qmax / a.BS + 1);
}

// Start one stage: keys [kpos0, kpos0 + n) of the slot, columns [col0,
// col0 + ncols) of each `width`-wide pool row, into `dst` (row j of the
// stage at dst + j * stride); rows n..kKeys and sentinel pages are zeroed.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ pool, int width, int col0,
                                          int ncols, const int* __restrict__ trow,
                                          const MlaShape& a, int kpos0, int n, int keys,
                                          unsigned char* dst, int stride) {
  const int pieces = ncols * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < keys * pieces; i += kThreads) {
    const int j = i / pieces, pc = i - j * pieces;
    unsigned char* d = dst + static_cast<size_t>(j) * stride + pc * 16;
    const int kpos = kpos0 + j;
    const int ent = j < n ? trow[kpos / a.BS] : -1;
    if (ent >= 0 && ent < a.NB) {
      const T* src = pool + (static_cast<size_t>(ent) * a.BS + kpos % a.BS) * width + col0;
      cp_async16(d, reinterpret_cast<const unsigned char*>(src) + pc * 16);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// float <-> int with the same order (finite values), for atomicMax
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The exp code of score x at key position kpos (0 if masked).
__device__ __forceinline__ int exp_code(float x, int kpos, int qpos, float mu, int vmax,
                                        const Alg1Consts& cst) {
  return kpos <= qpos ? alg1_exp(alg1_quantize(x, mu, cst) - vmax, cst) : 0;
}

// Per row of the head tile, in shared memory: the guarded row max (the max
// of the chunk maxima, order-free), its code, the integer row max (0 unless
// the row is fully masked, since quantize is monotone), and, when `sum` is
// set, the sum of the chunk sums. Four threads a row, each over a quarter
// of the chunks, so every row's loads are in flight at once. Ends with a
// barrier.
__device__ __forceinline__ void tile_row_stats(const Scratch& w, const MlaShape& a, int s,
                                               int r0, int nr, int n_live,
                                               const Alg1Consts& cst, float* mu, int* vmax,
                                               long long* sum) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float m = ALG1_NEG_INF;
  long long t = 0;
  if (r < nr) {
    for (int cc = part; cc < n_live; cc += 4) {
      const size_t at = (static_cast<size_t>(s) * n_chunks(a) + cc) * a.rows + r0 + r;
      m = fmaxf(m, w.cmax[at]);
      if (sum != nullptr) t += w.csum[at];
    }
  }
  for (int o = 1; o < 4; o <<= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  if (r < nr && part == 0) {
    const float g = m <= ALG1_NEG_INF ? 0.0f : m;  // fully masked row
    mu[r] = g;
    vmax[r] = alg1_quantize(m, g, cst);
    if (sum != nullptr) sum[r] = t;
  }
  __syncthreads();
}

// The row statistics of tile_row_stats (no sums), then the exact sum of the
// exp codes of keys [lo, lo + n) of every tile row (integer: exact in any
// order) into sum[r]: four threads a row, each over every fourth key,
// kLoadBatch scores loaded before their codes are taken (the first batch
// before the statistics, so the two round trips overlap), then two
// shuffles. Ends with a barrier.
__device__ __forceinline__ void stats_and_exp_sums(const Scratch& w, const MlaShape& a, int s,
                                                   int r0, int nr, int n_live, int lo, int n,
                                                   const int* prow, const Alg1Consts& cst,
                                                   float* mu, int* vmax, long long* sum) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const size_t l_full = static_cast<size_t>(a.NLOG) * a.BS;
  const float* srow =
      w.scores + (static_cast<size_t>(s) * a.rows + r0 + min(r, nr - 1)) * l_full + lo;
  float x[kLoadBatch];
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u)
      x[u] = r < nr && j0 + 4 * u < n ? srow[j0 + 4 * u] : 0.0f;
  };
  load(part);
  tile_row_stats(w, a, s, r0, nr, n_live, cst, mu, vmax, nullptr);
  long long acc = 0;
  if (r < nr) {
    const int qpos = prow[(r0 + r) / a.heads];
    const float m = mu[r];
    const int vm = vmax[r];
    for (int j0 = part; j0 < n; j0 += 4 * kLoadBatch) {
      if (j0 != part) load(j0);
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        if (j0 + 4 * u < n) acc += exp_code(x[u], lo + j0 + 4 * u, qpos, m, vm, cst);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (r < nr && part == 0) sum[r] = acc;
  __syncthreads();
}

// ------------------------------------------------------------ launch 1: scores

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
k4_scores(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
          const T* __restrict__ c_pool, const T* __restrict__ kr_pool,
          const int* __restrict__ table, const int* __restrict__ positions,
          float* __restrict__ scores_out, Scratch w, MlaShape a) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kKeys = Stage<T>::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, tile = blockIdx.y, s = blockIdx.z;
  const int* trow = table + static_cast<size_t>(s) * a.NLOG;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  start_next_grid();
  if (c == 0 && threadIdx.x == 0)  // launch 3 counts from 0
    for (int g = 0; g < n_groups(a); ++g) w.ticket[(s * n_tiles(a) + tile) * n_groups(a) + g] = 0;
  const int hi = live_hi(prow, a);
  const int pg0 = c * a.chunk_pages;
  if (pg0 >= hi) return;
  const int k0 = pg0 * a.BS, nk = min(pg0 + a.chunk_pages, hi) * a.BS - k0;
  const int r0 = tile * kTileRows, nr = min(kTileRows, a.rows - r0);
  const int l_full = a.NLOG * a.BS;
  const int r16 = static_cast<int>(round_up(a.R, 16)), width = qk_width(a);
  const int stride = row_stride<T>(width), cap = tile_cap(a);

  unsigned char* qs = smem;                                               // [cap, width]
  unsigned char* ring = smem + static_cast<size_t>(cap) * stride;         // 2 x [kKeys, width]
  int* smax = reinterpret_cast<int*>(ring + 2 * static_cast<size_t>(kKeys) * stride);
  const size_t buf = static_cast<size_t>(kKeys) * stride;
  const int nst = (nk + kKeys - 1) / kKeys;
  auto load = [&](int st) {
    const int kb = st * kKeys, n = min(kKeys, nk - kb);
    unsigned char* dst = ring + (st & 1) * buf;
    load_rows(c_pool, a.R, 0, a.R, trow, a, k0 + kb, n, kKeys, dst, stride);
    load_rows(kr_pool, a.DR, 0, a.DR, trow, a, k0 + kb, n, kKeys,
              dst + static_cast<size_t>(r16) * sizeof(T), stride);
  };
  // the tile's queries, [q_lat | 0 | q_rope | 0], in the first group with
  // stage 0; rows past nr zero
  const int pl = a.R * static_cast<int>(sizeof(T)) / 16;
  const int pieces = pl + a.DR * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < nr * pieces; i += kThreads) {
    const int r = i / pieces, pc = i - r * pieces;
    const size_t row = static_cast<size_t>(s) * a.rows + r0 + r;
    unsigned char* d = qs + static_cast<size_t>(r) * stride;
    if (pc < pl)
      cp_async16(d + pc * 16, reinterpret_cast<const unsigned char*>(q_lat + row * a.R) + pc * 16);
    else
      cp_async16(d + r16 * sizeof(T) + (pc - pl) * 16,
                 reinterpret_cast<const unsigned char*>(q_rope + row * a.DR) + (pc - pl) * 16);
  }
  for (int st = 0; st < 2; ++st) {
    if (st < nst) load(st);
    cp_async_commit();
  }
  const int units = stride / 16;
  for (int i = threadIdx.x; i < (cap - nr) * units; i += kThreads)
    *reinterpret_cast<uint4*>(qs + static_cast<size_t>(nr + i / units) * stride +
                              (i % units) * 16) = make_uint4(0, 0, 0, 0);
  if (r16 + a.DR < width || r16 > a.R) {
    // pad columns of the query rows and of both ring buffers (never written
    // by cp.async)
    for (int i = threadIdx.x; i < (nr + 2 * kKeys) * width; i += kThreads) {
      const int j = i / width, e = i - j * width;
      unsigned char* row = j < nr ? qs + static_cast<size_t>(j) * stride
                                  : ring + static_cast<size_t>(j - nr) * stride;
      if ((e >= a.R && e < r16) || e >= r16 + a.DR) reinterpret_cast<T*>(row)[e] = from_f<T>(0.0f);
    }
  }
  for (int r = threadIdx.x; r < kTileRows; r += kThreads) smax[r] = ordered(ALG1_NEG_INF);

  // one score: stored, and into the row's chunk max when valid
  auto emit = [&](int r, int j, float lat, float rope) {
    if (r >= nr || j >= nk) return;
    const float x = (round_to<T>(lat) + round_to<T>(rope)) * a.scale;
    const size_t at = (static_cast<size_t>(s) * a.rows + r0 + r) * l_full + k0 + j;
    w.scores[at] = x;
    if (scores_out != nullptr) scores_out[at] = x;
    if (k0 + j <= prow[(r0 + r) / a.heads]) atomicMax(smax + r, ordered(x));
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = (nr + 15) / 16;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait_one();
    __syncthreads();
    const int kb = st * kKeys, n = min(kKeys, nk - kb);
    const unsigned char* kt = ring + (st & 1) * buf;
    if constexpr (kMma) {
      // (m tile, n tile) pairs over the warps; each runs the R then the DR
      // k16 steps into its own accumulator
      const int nt = (n + 7) / 8;
      for (int p = warp; p < mt * nt; p += kWarps) {
        const int mi = p % mt, ni = p / mt;
        const unsigned char* arow = qs + static_cast<size_t>(mi * 16 + (lane & 15)) * stride +
                                    (lane >> 4) * 16;
        const unsigned char* brow = kt + static_cast<size_t>(ni * 8 + (lane & 7)) * stride +
                                    ((lane >> 3) & 1) * 16;
        float lat[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rope[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int k = 0; k < r16; k += 16) {
          unsigned af[4], bf[2];
          ldsm_x4(af, arow + k * 2);
          ldsm_x2(bf, brow + k * 2);
          mma_bf16(lat, af, bf);
        }
#pragma unroll 4
        for (int k = r16; k < width; k += 16) {
          unsigned af[4], bf[2];
          ldsm_x4(af, arow + k * 2);
          ldsm_x2(bf, brow + k * 2);
          mma_bf16(rope, af, bf);
        }
        // c0, c1: row lane / 4, keys 2 (lane % 4) + {0, 1}; c2, c3: row + 8
        const int r = mi * 16 + (lane >> 2), j = kb + ni * 8 + (lane & 3) * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) emit(r + (e >> 1) * 8, j + (e & 1), lat[e], rope[e]);
      }
    } else {
      for (int i = threadIdx.x; i < nr * n; i += kThreads) {
        const int r = i / n, j = i - r * n;
        const float* qr = reinterpret_cast<const float*>(qs + static_cast<size_t>(r) * stride);
        const float* kr = reinterpret_cast<const float*>(kt + static_cast<size_t>(j) * stride);
        float lat = 0.0f, rope = 0.0f;
        for (int d = 0; d < a.R; ++d) lat = fmaf(qr[d], kr[d], lat);
        for (int d = 0; d < a.DR; ++d) rope = fmaf(qr[r16 + d], kr[r16 + d], rope);
        emit(r, kb + j, lat, rope);
      }
    }
    __syncthreads();
    if (st + 2 < nst) load(st + 2);
    cp_async_commit();
  }
  for (int r = threadIdx.x; r < nr; r += kThreads)
    w.cmax[(static_cast<size_t>(s) * n_chunks(a) + c) * a.rows + r0 + r] = unordered(smax[r]);
}

// ------------------------------------------------------------ launch 2: sums

// Each chunk's exact sum of exp codes per row.
__global__ void __launch_bounds__(kThreads)
k4_sums(const int* __restrict__ positions, Scratch w, MlaShape a, Alg1Consts cst) {
  __shared__ float mu[kTileRows];
  __shared__ int vmax[kTileRows];
  __shared__ long long sum[kTileRows];
  const int c = blockIdx.x, tile = blockIdx.y, s = blockIdx.z;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  start_next_grid();
  wait_previous_grid();
  const int hi = live_hi(prow, a);
  const int pg0 = c * a.chunk_pages;
  if (pg0 >= hi) return;
  const int k0 = pg0 * a.BS, nk = min(pg0 + a.chunk_pages, hi) * a.BS - k0;
  const int n_live = (hi + a.chunk_pages - 1) / a.chunk_pages;
  const int r0 = tile * kTileRows, nr = min(kTileRows, a.rows - r0);
  stats_and_exp_sums(w, a, s, r0, nr, n_live, k0, nk, prow, cst, mu, vmax, sum);
  for (int r = threadIdx.x; r < nr; r += kThreads)
    w.csum[(static_cast<size_t>(s) * n_chunks(a) + c) * a.rows + r0 + r] = sum[r];
}

// ------------------------------------------------------------ launch 3: PV

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
k4_pv(const T* __restrict__ c_pool, const int* __restrict__ table,
      const int* __restrict__ positions, T* __restrict__ out, float* __restrict__ probs_out,
      Scratch w, MlaShape a, Alg1Consts cst, int sums_here) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kKeys = Stage<T>::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int c = blockIdx.x, s = blockIdx.z;
  const int tile = blockIdx.y / n_groups(a), g = blockIdx.y - tile * n_groups(a);
  const int* trow = table + static_cast<size_t>(s) * a.NLOG;
  const int* prow = positions + static_cast<size_t>(s) * a.T;
  const int r0 = tile * kTileRows, nr = min(kTileRows, a.rows - r0);
  const int col0 = g * kPvCols, ncols = min(kPvCols, a.R - col0);
  const int hi = live_hi(prow, a);
  T* ob = out + (static_cast<size_t>(s) * a.rows + r0) * a.R + col0;
  if (hi == 0) {  // no live page: the sum is empty
    wait_previous_grid();
    if (c == 0)
      for (int i = threadIdx.x; i < nr * ncols; i += kThreads)
        ob[static_cast<size_t>(i / ncols) * a.R + i % ncols] = from_f<T>(0.0f);
    return;
  }
  const int pg0 = c * a.chunk_pages;
  if (pg0 >= hi) return;
  const int k0 = pg0 * a.BS, nk = min(pg0 + a.chunk_pages, hi) * a.BS - k0;
  const int n_live = (hi + a.chunk_pages - 1) / a.chunk_pages, nc = n_chunks(a);
  const size_t l_full = static_cast<size_t>(a.NLOG) * a.BS;
  const int cap = tile_cap(a);

  float* rmu = reinterpret_cast<float*>(smem);                            // [kTileRows]
  int* rvmax = reinterpret_cast<int*>(smem + kTileRows * 4);              // [kTileRows]
  long long* rsum = reinterpret_cast<long long*>(smem + 2 * kTileRows * 4);  // [kTileRows]
  float* sring = reinterpret_cast<float*>(smem + 4 * kTileRows * 4);      // 2 x [cap, kKeys]
  unsigned char* pt = reinterpret_cast<unsigned char*>(sring + 2 * cap * kKeys);  // P [cap, kKeys]
  const int sp = row_stride<T>(kKeys);
  unsigned char* ring = pt + static_cast<size_t>(cap) * sp;               // 2 x [kKeys, kPvCols]
  const int sv = row_stride<T>(kPvCols);
  const size_t buf = static_cast<size_t>(kKeys) * sv;
  const float* scores = w.scores + static_cast<size_t>(s) * a.rows * l_full;

  // one stage: its latent columns (a cp.async group of their own before the
  // wait, then with the stage's scores)
  const int nst = (nk + kKeys - 1) / kKeys;
  auto load_latent = [&](int st) {
    const int kb = st * kKeys;
    load_rows(c_pool, a.R, col0, ncols, trow, a, k0 + kb, min(kKeys, nk - kb), kKeys,
              ring + (st & 1) * buf, sv);
  };
  auto load_scores = [&](int st) {
    const int kb = st * kKeys, n = min(kKeys, nk - kb);
    float* dst = sring + (st & 1) * cap * kKeys;
    for (int i = threadIdx.x; i < nr * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i - r * kKeys;
      if (j < n) cp_async4(dst + i, scores + (static_cast<size_t>(r0) + r) * l_full + k0 + kb + j);
    }
  };
  for (int st = 0; st < 2; ++st) {
    if (st < nst) load_latent(st);
    cp_async_commit();
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  wait_previous_grid();  // launch 1's scores and maxima, or launch 2's sums
  // the first two stages' scores fly under the row statistics
  for (int st = 0; st < 2; ++st) {
    if (st < nst) load_scores(st);
    cp_async_commit();
  }
  if (sums_here) {
    stats_and_exp_sums(w, a, s, r0, nr, n_live, 0, hi * a.BS, prow, cst, rmu, rvmax, rsum);
  } else {
    tile_row_stats(w, a, s, r0, nr, n_live, cst, rmu, rvmax, rsum);
  }
  // the totals, max(min(sum, sum_sat), 1), in place
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    const long long clipped = rsum[r] < cst.sum_sat ? rsum[r] : cst.sum_sat;
    rsum[r] = clipped > 1 ? clipped : 1;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = (nr + 15) / 16;
  for (int st = 0; st < nst; ++st) {
    // this stage's latent columns and scores (the groups up to it) have
    // landed; the totals, or the last stage's readers of P, are done
    cp_async_wait_one();
    __syncthreads();
    const int kb = st * kKeys, n = min(kKeys, nk - kb);
    const float* sc = sring + (st & 1) * cap * kKeys;
    // this stage's probabilities, rounded to cdt; zero past the keys
    for (int i = threadIdx.x; i < cap * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i - r * kKeys;
      float p = 0.0f;
      if (r < nr && j < n) {
        const int kpos = k0 + kb + j;
        const int va = exp_code(sc[i], kpos, prow[(r0 + r) / a.heads], rmu[r], rvmax[r], cst);
        p = alg1_prob_fast(va, static_cast<int>(rsum[r]), cst);
        if (probs_out != nullptr && g == 0)
          probs_out[(static_cast<size_t>(s) * a.rows + r0 + r) * l_full + kpos] = p;
      }
      reinterpret_cast<T*>(pt + static_cast<size_t>(r) * sp)[j] = from_f<T>(p);
    }
    __syncthreads();
    const unsigned char* vt = ring + (st & 1) * buf;
    if constexpr (kMma) {
      // warp w: columns 8 w .. 8 w + 7 of the group, every m tile, the
      // stage's keys 16 at a time in order
      if (warp * 8 < ncols) {
        for (int ks = 0; ks * 16 < n; ++ks) {
          unsigned bf[2];
          ldsm_x2_trans(bf, vt + static_cast<size_t>(ks * 16 + (lane & 15)) * sv + warp * 16);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            if (mi < mt) {
              unsigned af[4];
              ldsm_x4(af, pt + static_cast<size_t>(mi * 16 + (lane & 15)) * sp +
                              (ks * 16 + (lane >> 4) * 8) * 2);
              mma_bf16(acc + 4 * mi, af, bf);
            }
          }
        }
      }
    } else {
      // thread: column tid % 64 of the group, rows tid / 64 + 4 i, key by key
      const int col = threadIdx.x % kPvCols, rg = threadIdx.x / kPvCols;
      if (col < ncols) {
        for (int j = 0; j < n; ++j) {
          const float v = reinterpret_cast<const float*>(vt + static_cast<size_t>(j) * sv)[col];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int r = rg + 4 * i;
            if (r < nr)
              acc[i] = fmaf(reinterpret_cast<const float*>(pt + static_cast<size_t>(r) * sp)[j],
                            v, acc[i]);
          }
        }
      }
    }
    if (st + 2 < nst) {
      __syncthreads();  // every warp is done with this stage's buffers
      load_latent(st + 2);
      load_scores(st + 2);
    }
    cp_async_commit();
  }

  // this chunk's partial; the last chunk of (slot, head tile, column group)
  // to finish adds them in chunk order and rounds once
  float* part = w.part + (static_cast<size_t>(s) * nc * a.rows + r0) * a.R + col0;
  const size_t chunk_stride = static_cast<size_t>(a.rows) * a.R;
  float* mine = part + c * chunk_stride;
  if constexpr (kMma) {
    if (warp * 8 < ncols) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mi * 16 + (lane >> 2) + h * 8;
          if (mi < mt && r < nr)
            *reinterpret_cast<float2*>(mine + static_cast<size_t>(r) * a.R + warp * 8 +
                                       (lane & 3) * 2) =
                make_float2(acc[4 * mi + 2 * h], acc[4 * mi + 2 * h + 1]);
        }
      }
    }
  } else {
    const int col = threadIdx.x % kPvCols, rg = threadIdx.x / kPvCols;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = rg + 4 * i;
      if (col < ncols && r < nr) mine[static_cast<size_t>(r) * a.R + col] = acc[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(w.ticket + (s * n_tiles(a) + tile) * n_groups(a) + g, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // four columns (a float4) of up to kOuts outputs a thread, all of them in
  // one pass (nr x ncols / 4 <= kOuts x kThreads), kBatch chunks at a time:
  // the loads are independent, each output's adds stay in chunk order
  constexpr int kBatch = 2, kOuts = kTileRows * kPvCols / 4 / kThreads;
  const int quads = ncols / 4, n_out = nr * quads;
  size_t at[kOuts];
  float4 x[kOuts];
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int i = threadIdx.x + o * kThreads;
    at[o] = static_cast<size_t>(i / quads) * a.R + (i % quads) * 4;
    x[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int c0 = 0; c0 < n_live; c0 += kBatch) {
    float4 v[kOuts][kBatch];
#pragma unroll
    for (int o = 0; o < kOuts; ++o)
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[o][u] = threadIdx.x + o * kThreads < n_out && c0 + u < n_live
                      ? __ldcg(reinterpret_cast<const float4*>(part + (c0 + u) * chunk_stride +
                                                               at[o]))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int o = 0; o < kOuts; ++o)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u < n_live) {
          x[o].x += v[o][u].x;
          x[o].y += v[o][u].y;
          x[o].z += v[o][u].z;
          x[o].w += v[o][u].w;
        }
      }
  }
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    if (threadIdx.x + o * kThreads < n_out) {
      ob[at[o]] = from_f<T>(x[o].x);
      ob[at[o] + 1] = from_f<T>(x[o].y);
      ob[at[o] + 2] = from_f<T>(x[o].z);
      ob[at[o] + 3] = from_f<T>(x[o].w);
    }
  }
}

// ------------------------------------------------------------ host

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* c_pool, const void* kr_pool,
           const int* table, const int* positions, void* out, float* scores_out,
           float* probs_out, void* scratch, const MlaShape& a, const Alg1Consts& c,
           cudaStream_t stream) {
  static int allowed_scores = 48 * 1024, allowed_pv = 48 * 1024;
  int optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t sm1 = scores_smem<T>(a), sm3 = pv_smem<T>(a);
  if (sm1 > static_cast<size_t>(optin) || sm3 > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(k4_scores<T>, sm1, &allowed_scores);
  if (err == cudaSuccess) err = allow_smem(k4_pv<T>, sm3, &allowed_pv);
  if (err != cudaSuccess) return static_cast<int>(err);
  // launch 3 sums the exp codes itself for short rows: no launch 2
  const int sums_here =
      static_cast<size_t>(tile_cap(a)) * a.NLOG * a.BS <= static_cast<size_t>(kSumsHereScores);
  const Scratch w = carve(a, scratch);
  const dim3 grid(n_chunks(a), n_tiles(a), a.S);
  k4_scores<T><<<grid, kThreads, sm1, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(c_pool), static_cast<const T*>(kr_pool), table, positions,
      scores_out, w, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // launches 2 and 3 may start early (programmatic dependent launch) and
  // wait in the kernel: launch 3 starts its latent loads before it waits
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
    cfg.dynamicSmemBytes = 0;
    err = cudaLaunchKernelEx(&cfg, k4_sums, positions, w, a, c);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cfg.gridDim = dim3(n_chunks(a), n_tiles(a) * n_groups(a), a.S);
  cfg.dynamicSmemBytes = sm3;
  err = cudaLaunchKernelEx(&cfg, k4_pv<T>, static_cast<const T*>(c_pool), table, positions,
                           static_cast<T*>(out), probs_out, w, a, c, sums_here);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Bytes of scratch one launch of shape `a` needs (the wrapper allocates it).
extern "C" size_t paged_attention_mla_scratch_bytes(MlaShape a) {
  size_t off[5];
  return scratch_layout(a, off);
}

// Launch on `stream`; returns a CUDA error code (0 on success). dtype: 0
// bfloat16, 1 float32 (queries, both pools and out share it). `scratch`
// holds paged_attention_mla_scratch_bytes(a) bytes. The caller allocates
// `out` and checks shapes and alignment (ops.py:paged_attention_mla_rows).
extern "C" int paged_attention_mla_launch(const void* q_lat, const void* q_rope,
                                          const void* c_pool, const void* kr_pool,
                                          const int* table, const int* positions, void* out,
                                          float* scores_out, float* probs_out, void* scratch,
                                          int dtype, MlaShape a, Alg1Consts c, void* stream) {
  if (a.S < 1 || a.T < 1 || a.heads < 1 || a.rows != a.T * a.heads || a.R < 8 ||
      a.R > kMaxR || a.R % 8 != 0 || a.DR < 8 || a.DR > kMaxDr || a.DR % 8 != 0 ||
      a.NB < 1 || a.BS < 1 || a.NLOG < 1 || a.chunk_pages < 1 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q_lat, q_rope, c_pool, kr_pool, table, positions, out,
                                 scores_out, probs_out, scratch, a, c, st);
  if (dtype == 1)
    return launch<float>(q_lat, q_rope, c_pool, kr_pool, table, positions, out, scores_out,
                         probs_out, scratch, a, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
