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
// Bound on an H100: at a 512-token prefill (d 128) the bytes (q, k, v read
// once, the f32 output written once); from ~2048 tokens the operations: the
// two products on tensor cores and Alg. 1's ~40 integer operations a valid
// score on the ALUs, which take longer than the products.
//
// Design. The whole-row design this replaces kept a CTA's f32 score rows
// over all keys in shared memory (so 1-16 rows a CTA, every tile re-reading
// K and V, a cap on context), ran both products on CUDA cores and divided
// each probability in int64. Flash-style rescaling does not hold for Alg. 1
// (the DESIGN NOTE of src/repro/kernels/paged_attention/kernel.py), but
// Alg. 1 splits exactly into passes over the same scores: the fp row max is
// order-free, the integer row max is the code of the fp max (alg1_guard),
// the int64 sum clipped once is exact in any order, and the division is
// elementwise by one total a row. A score tile recomputed by the same
// instructions gives the same bits, so the passes recompute QK^T instead of
// keeping [rows, Skv] scores anywhere:
//   * one CTA per (bh, query tile), 16 rows a warp, the longest tiles (the
//     last, under causal) launched first. A query tile visits only the key
//     tiles some row of it attends (ref.py:k3_plan): under causal up to its
//     largest qpos, with a window from its smallest qpos - window + 1; keys
//     inside a boundary tile are masked per element, the others skip the
//     mask test. One pipeline of two stages runs through the three passes,
//     so it never drains, with one barrier a step (the next step's tile goes
//     into the slots the step before read). Shared memory depends on d (and
//     M) alone: no cap on context.
//   * pass 1, row max: S = Q K^T for the warp's rows, scaled by __fmul_rn,
//     masked, the running fp max per row (per thread, then a quad shuffle).
//     scores_out is written here.
//   * pass 2, sums: S recomputed by the same function; each valid score's
//     exp code from its index (alg1_exp_index_rcp: a branch-free division by
//     S, checked against IEEE division over every f32 it may divide, and a
//     magic-add rint) in a table of the 2^(M-1) + 1 codes built per CTA (M
//     <= 14; above, alg1_exp inline); int64 row sums, then a quad shuffle
//     and alg1_sum_div.
//   * pass 3, probabilities and PV: S, codes and exps recomputed; each
//     probability by alg1_prob_row (one reciprocal a row); probs_out is
//     written here. bf16: the probabilities rounded to bf16 and repacked
//     from the C fragments into mma A fragments in registers, P V on
//     mma.sync m16n8k16 with B = the V tile by ldmatrix.trans; f32: fmaf
//     key by key, each probability broadcast across its quad by a shuffle.
//     O is accumulated in f32 registers in key order (16 keys a
//     tensor-core step in bf16) and written once.
// Three paths, by dtype and d:
//   * bf16, d <= 128 (the models' widths): Q held as A fragments in
//     registers; the scores on wgmma m64n64k16 (A = Q from registers, B =
//     the K tile by descriptor: a warpgroup reads each K tile once, where
//     with mma.sync each warp reads all of it by ldmatrix); Q, K and V tiles
//     by TMA (one thread issues a step's boxes, an mbarrier a stage; boxes
//     land in wgmma's K-major core-matrix layout, ragged rows and the d
//     padding zero-filled). CTAs of two warpgroups (128 query rows, one an
//     SM) where the grid keeps two on every SM, else one (64 rows, two an
//     SM): ref.py:k3_tiles. In same-call timings (probes/k3_variants.py,
//     PERF.md §6) the mma.sync + cp.async build of this source
//     (-DK3_MMA_SYNC) is slower at every full-width shape.
//   * bf16, d 136..256: Q from shared memory by ldmatrix, the scores on
//     mma.sync (each warp reading the K tile by ldmatrix), 16-byte cp.async
//     tiles into staged rows, CTAs of 4 warps (64 rows).
//   * f32 (the reference matrix): each dot fmaf in d order, no TF32 (it
//     would change the products), Q in shared memory, 16 keys a tile,
//     cp.async, CTAs of 4 warps. The f32 bounds of the plain version hold.
// No atomics, one launch a call: the same call gives the same bits run
// after run.
//
// Rounding of the tensor-core sums: the checks of chip_smoke.py do not
// assume round-to-nearest inside an mma or wgmma; they bound each 16-deep
// step as fused sums that keep 24 bits of their largest addend and truncate
// (chip_smoke.py:MMA_UNIT). wgmma and mma.sync gave the same bits here.
//
// d is a multiple of 8 within 256 and q, k, v are 16-byte aligned (the
// wrapper checks); d is padded with zeros to a multiple of 16 in shared
// memory. scores_out / probs_out ([BH, Sq, Skv] f32, may be null) take the
// scores and probabilities of the visited key tiles for the chip smoke
// test's checks; other keys are left as the caller filled them.
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "alg1.cuh"
#include "paged_common.cuh"
#include "tensor_core.cuh"

// Shapes and options of one launch (mirrored by ctypes in
// repro_torch/kernels/int_attention/ops.py:AttnShape).
struct AttnShape {
  int BH;      // batch x query heads
  int group;   // query heads per kv head: kv row = bh / group
  int Sq;      // query rows
  int Skv;     // keys
  int D;       // head dim (<= 256, a multiple of 8)
  int causal;  // 1: right-aligned causal mask
  int window;  // with causal: sliding window (0: none)
  int q_tile;  // the plan's tiles (ref.py:k3_plan): must equal the kernel's
  int k_tile;
  float scale;  // d^-1/2
};

namespace {

// The cp.async paths' CTA: 4 warps, 64 query rows, an m16 tile a warp.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;
constexpr int kMaxD = 256;
constexpr int kMaxTableM = 14;       // largest exp table: 2^13 + 1 codes, 32 KB

// Keys a tile: four k16 steps of the bf16 PV product; f32 rows are twice as
// wide and Q stays in shared memory, so fewer keys keep d 256 inside it.
template <typename T>
struct Tile {
  static constexpr int kKeys = sizeof(T) == 2 ? 64 : 16;
};

// Q is held as mma A fragments in registers up to d 128 (KS <= 8 k steps).
template <typename T, int KS>
struct QInRegs {
  static constexpr bool value = std::is_same<T, __nv_bfloat16>::value && KS <= 8;
};

// The bf16 scores run on wgmma where Q is in registers: the warpgroup reads
// each K tile once, where with mma.sync each warp reads all of it by
// ldmatrix. -DK3_MMA_SYNC keeps mma.sync (probes/k3_variants.py).
template <typename T, int KS>
struct ScoresOnWgmma {
#ifdef K3_MMA_SYNC
  static constexpr bool value = false;
#else
  static constexpr bool value = QInRegs<T, KS>::value;
#endif
};

// bytes between staged rows: d padded to 16, plus 16 bytes, an odd number
// of 16-byte units, so the eight row addresses of an ldmatrix fall in
// distinct banks
template <typename T>
__host__ __device__ __forceinline__ int row_stride(int d) {
  return static_cast<int>(round_up(d, 16) * sizeof(T) + 16);
}

// Shared memory of a launch (ref.py:k3_smem_bytes): the ring of two K and
// two V slots of kKeys rows each; the Q tile where it has its own slot; the
// exp table. On the wgmma path the slots are TMA boxes (d padded to 16 and
// no more), behind up to 128 bytes of alignment, with two mbarriers; else
// staged rows.
template <typename T, int KS>
__host__ __device__ inline size_t smem_bytes(int d, int m) {
  const size_t keys = Tile<T>::kKeys;
  const size_t table = m <= kMaxTableM ? ((1u << (m - 1)) + 1) * 4u : 0u;
  if (ScoresOnWgmma<T, KS>::value) return 128 + 4 * keys * round_up(d, 16) * sizeof(T) + 16 + table;
  const size_t stride = row_stride<T>(d);
  return 4 * keys * stride + (QInRegs<T, KS>::value ? 0 : kQTile * stride) + table;
}

__device__ __forceinline__ bool valid_key(int kpos, int qpos, const AttnShape& a) {
  return kpos < a.Skv &&
         (!a.causal || (kpos <= qpos && (a.window == 0 || qpos - kpos < a.window)));
}

// Keys [lo, hi) some row of query rows [r0, r0 + nr) attends (ref.py:k3_span).
__device__ __forceinline__ void key_span(int r0, int nr, const AttnShape& a, int* lo, int* hi) {
  const int shift = a.Skv - a.Sq;  // qpos of row i is i + shift
  *lo = 0;
  *hi = a.Skv;
  if (a.causal) {
    *hi = max(0, min(a.Skv, r0 + nr + shift));
    if (a.window) *lo = min(*hi, max(0, r0 + shift - a.window + 1));
  }
}

// Start a copy of `rows` staged rows from `src` (row j at src + j D, on
// to `dst` + j stride): rows below n by cp.async, the others zeroed.
// Columns D.. of a row are never written (zeroed once at the start). Thread
// t copies piece t % pieces of rows t / pieces, + kThreads / pieces, ...
// (threads past the last whole group of rows idle): a warp writes whole
// rows, whose odd number of 16-byte units a stride keeps the banks apart.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int n, int rows, int d,
                                          unsigned char* dst, int stride) {
  const int pieces = d * static_cast<int>(sizeof(T)) / 16, step = kThreads / pieces;
  const int pc = threadIdx.x % pieces;
  if (static_cast<int>(threadIdx.x) >= step * pieces) return;
  for (int j = threadIdx.x / pieces; j < rows; j += step) {
    unsigned char* to = dst + static_cast<size_t>(j) * stride + pc * 16;
    if (j < n)
      cp_async16(to, reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(j) * d) +
                         pc * 16);
    else
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
  }
}

// The warp's scores against one key tile, scaled: s[n][e] is row g + 8 (e /
// 2) of the warp's 16 and key 8 n + 2 t + e % 2 of the tile (g = lane / 4,
// t = lane % 4: the mma's C layout). Every pass calls this with the same
// operands, so each gets the same bits.
template <int KS, bool QREGS>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const unsigned (&qf)[KS][4],
                                            const unsigned char* qw,
                                            const unsigned char* kt, int stride, int nks,
                                            float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  // A: rows lane % 16, k half lane / 16; B (x4): two n tiles at one k step,
  // keys 8 (lane / 16) + lane % 8, k half (lane / 8) % 2
  const unsigned char* arow = qw + static_cast<size_t>(lane & 15) * stride + (lane >> 4) * 16;
  const unsigned char* brow =
      kt + static_cast<size_t>((lane >> 4) * 8 + (lane & 7)) * stride + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < nks) {
      unsigned af[4];
      if constexpr (QREGS) {
        af[0] = qf[ks][0];
        af[1] = qf[ks][1];
        af[2] = qf[ks][2];
        af[3] = qf[ks][3];
      } else {
        ldsm_x4(af, arow + ks * 32);
      }
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned b[4];
        ldsm_x4(b, brow + static_cast<size_t>(n * 8) * stride + ks * 32);
        const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(s[n], af, b0);
        mma_bf16(s[n + 1], af, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
}

// The same on wgmma: the warpgroup's 64 rows (A = Q from registers) against
// the K tile as the TMA box lays it out (piece p of key r at p 1024 + r 16:
// core matrices 1024 bytes apart along d, 128 along the keys), d in 16-deep
// steps in a fixed order.
template <int KS>
__device__ __forceinline__ void tile_scores_wgmma(float (&s)[8][4], const unsigned (&qf)[KS][4],
                                                  const unsigned char* kt, int nks,
                                                  float scale) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    if (ks < nks) wgmma_m64n64k16(s, qf[ks], wgmma_desc(kt + ks * 2048, 1024, 128), ks);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
}

// The same for f32 rows (Q from shared memory): each dot fmaf in d order.
__device__ __forceinline__ void tile_scores_f32(float (&s)[2][4], const unsigned char* qw,
                                                const unsigned char* kt, int stride, int d,
                                                float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* q0 = reinterpret_cast<const float*>(qw + static_cast<size_t>(g) * stride);
  const float* q1 = reinterpret_cast<const float*>(qw + static_cast<size_t>(g + 8) * stride);
  const float* kr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    kr[i] = reinterpret_cast<const float*>(
        kt + static_cast<size_t>(8 * (i >> 1) + 2 * t + (i & 1)) * stride);
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int k = 0; k < d; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q0 + k);
    const float4 b = *reinterpret_cast<const float4*>(q1 + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(kr[i] + k);
      float& u = acc[i >> 1][i & 1];
      float& w = acc[i >> 1][2 + (i & 1)];
      u = fmaf(a.x, x.x, u); u = fmaf(a.y, x.y, u); u = fmaf(a.z, x.z, u); u = fmaf(a.w, x.w, u);
      w = fmaf(b.x, x.x, w); w = fmaf(b.y, x.y, w); w = fmaf(b.z, x.z, w); w = fmaf(b.w, x.w, w);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(acc[n][e], scale);
}


__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// A CTA of WARPS warps: 16 query rows a warp. The TMA path takes one
// warpgroup (64 rows, two CTAs an SM) or two (128 rows, one): the wider
// tile's K and V loads serve twice the rows, which sets the pace at long
// rows; the narrower fills the card better when the grid is short
// (ref.py:k3_tiles). The cp.async paths take one.
template <typename T, int KS, int WARPS>
struct Cta {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kRows = 16 * WARPS;
  static constexpr int kMinBlocks = WARPS == 8 ? 1 : QInRegs<T, KS>::value ? 2 : 1;
};

// ------------------------------------------------------------ TMA tiles

// The TMA path's tensor maps (the wgmma path: bf16, d <= 128): q, k and v
// each as [heads, rows, D] viewed 4-D as {8 elements, rows, D / 8 pieces,
// heads}, boxes of {8, 64 rows (q: 128), d16 / 8, 1}: a box lands in
// wgmma's K-major core-matrix layout without swizzle, piece p of row r at
// p 1024 + r 16 (q: p 2048 + r 16), and rows past the head's end and
// pieces past D come as zeros. (Boxes of 64 columns in the 128-byte
// swizzle, with XOR-addressed ldmatrix, were slower on the H100: PERF.md
// §6.)
struct TileMaps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// this thread's arrival, expecting `bytes` more from the tensor copies
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for phase `parity` of `bar`; a stage that has not landed after ~10 s
// of clock is a fault: trap (the launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}
// the box at (0, row, 0, head) of `map` into `dst`, completing on `bar`
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int row, int head,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(0), "r"(row), "r"(0), "r"(head),
      "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int KS, bool TABLE, int WARPS>
__global__ void __launch_bounds__(Cta<T, KS, WARPS>::kThreads, Cta<T, KS, WARPS>::kMinBlocks)
k3_attention(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             float* __restrict__ out, float* __restrict__ scores_out,
             float* __restrict__ probs_out, AttnShape a, Alg1Consts c,
             const __grid_constant__ TileMaps maps) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kQRegs = QInRegs<T, KS>::value;
  constexpr bool kTma = ScoresOnWgmma<T, KS>::value;  // wgmma scores, TMA tiles
  constexpr int kKeys = Tile<T>::kKeys;
  constexpr int kQRows = Cta<T, KS, WARPS>::kRows;
  static_assert(!kTma || kKeys == 64, "the K and V boxes and wgmma take 64 keys");
  constexpr int kNT = kKeys / 8;                   // n tiles of a score tile
  constexpr int kOT = kMma ? 2 * KS : kMaxD / 8;   // n tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int n_qt = (a.Sq + kQRows - 1) / kQRows;
  const int bh = blockIdx.x % a.BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / a.BH;  // longest tiles first
  const int r0 = qt * kQRows, nr = min(kQRows, a.Sq - r0);
  int lo, hi;
  key_span(r0, nr, a, &lo, &hi);
  const int t0 = lo / kKeys, nt = hi > lo ? (hi + kKeys - 1) / kKeys - t0 : 0;
  const size_t q_row0 = static_cast<size_t>(bh) * a.Sq + r0;
  float* ob = out + q_row0 * a.D;
  if (nt == 0) {  // no row of the tile attends any key: the sum is empty
    for (int i = threadIdx.x; i < nr * a.D; i += blockDim.x) ob[i] = 0.0f;
    return;
  }

  const int stride = row_stride<T>(a.D), d16 = static_cast<int>(round_up(a.D, 16));
  // Slots: K of stages 0 and 1, then V of stages 0 and 1; TMA: 64 rows of
  // d16 in the core layout, 128-byte aligned; else staged rows. Q is staged
  // in the V slots when it goes to registers (V is first loaded in pass 3;
  // TMA: 128 rows, piece p of row r at p 2048 + r 16), else in its own slot
  // after them.
  unsigned char* ring =
      kTma ? smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u) : smem_raw;
  const size_t slot = kTma ? static_cast<size_t>(kKeys) * d16 * sizeof(T)
                           : static_cast<size_t>(kKeys) * stride;
  unsigned char* vring = ring + 2 * slot;
  unsigned char* qs = kQRegs ? vring : vring + 2 * slot;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(vring + 2 * slot);
  int* table = reinterpret_cast<int*>(kTma ? vring + 2 * slot + 16
                                           : vring + 2 * slot + (kQRegs ? 0 : kQRows * stride));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const float rcp_s = __frcp_rn(c.S);
  const int kvh = bh / a.group;
  const size_t kv_row = static_cast<size_t>(kvh) * a.Skv;

  // the pad columns D..d16 of every staged row (never written by cp.async;
  // TMA zero-fills them)
  if (!kTma && d16 > a.D) {
    const int n_rows = 4 * kKeys + (kQRegs ? 0 : kQRows), pad = d16 - a.D;
    for (int i = threadIdx.x; i < n_rows * pad; i += kThreads)
      reinterpret_cast<T*>(ring + static_cast<size_t>(i / pad) * stride)[a.D + i % pad] =
          from_f<T>(0.0f);
  }
  alg1_build_table<TABLE>(table, c);

  // step s of the pipeline: pass s / nt on key tile t0 + s % nt; its K (and,
  // in pass 3, V) tile into stage s % 2. Q comes with step 0.
  const int n_steps = 3 * nt;
  const unsigned tile_bytes = static_cast<unsigned>(slot);
  // (TMA: one thread; `extra` more bytes come on the same barrier)
  auto load_step = [&](int s, unsigned extra) {
    const int kb = (t0 + s % nt) * kKeys;
    if constexpr (kTma) {
      mbar_expect_tx(bars + (s & 1), (s >= 2 * nt ? 2 : 1) * tile_bytes + extra);
      tma_tile(ring + (s & 1) * slot, &maps.k, kb, kvh, bars + (s & 1));
      if (s >= 2 * nt) tma_tile(vring + (s & 1) * slot, &maps.v, kb, kvh, bars + (s & 1));
    } else {
      const int n = min(kKeys, a.Skv - kb);
      load_rows(k + (kv_row + kb) * a.D, n, kKeys, a.D, ring + (s & 1) * slot, stride);
      if (s >= 2 * nt)
        load_rows(v + (kv_row + kb) * a.D, n, kKeys, a.D, vring + (s & 1) * slot, stride);
    }
  };
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 1, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      load_step(0, kQRows / 64 * tile_bytes);  // and Q
      tma_tile(qs, &maps.q, r0, bh, bars);
    }
  } else {
    load_rows(q + q_row0 * a.D, nr, kQRows, a.D, qs, stride);
    load_step(0, 0);
    cp_async_commit();
  }

  unsigned qf[KS][4];
  const int qpos0 = r0 + warp * 16 + g + (a.Skv - a.Sq);  // row g's; row g + 8: + 8
  float m[2] = {ALG1_NEG_INF, ALG1_NEG_INF};
  int off[2] = {0, 0};
  long long sum[2] = {0, 0};
  Alg1RowDiv rd[2];
  float o[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    // one barrier a step: every warp is done with step s - 1's stage, which
    // the next loads refill, and (cp.async) step s's stage has landed
    if constexpr (kTma) {
      __syncthreads();
      if (threadIdx.x == 0 && s + 1 < n_steps) load_step(s + 1, 0);
      mbar_wait(bars + (s & 1), (s >> 1) & 1);
    } else {
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < n_steps) load_step(s + 1, 0);
      cp_async_commit();
    }
    const int pass = s / nt, kb = (t0 + s % nt) * kKeys;
    const unsigned char* kt = ring + (s & 1) * slot;
    const unsigned char* vt = vring + (s & 1) * slot;
    if constexpr (kQRegs) {
      if (s == 0) {  // A fragments: rows lane % 16 of the warp's, k half lane / 16
        const int r = warp * 16 + (lane & 15);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          if (ks * 16 < d16)
            ldsm_x4(qf[ks], kTma ? qs + (2 * ks + (lane >> 4)) * (kQRows * 16) + r * 16
                                 : qs + static_cast<size_t>(r) * stride + (lane >> 4) * 16 +
                                       ks * 32);
      }
    }
    if (s == nt) {  // the row maxima, guarded
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
        alg1_guard(m[h], off[h], c);
      }
    }
    if (s == 2 * nt) {  // the row totals
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        rd[h] = alg1_sum_div(sum[h], c);
      }
    }

    float sc[kMma ? 8 : 2][4];
    const unsigned char* qw = qs + static_cast<size_t>(warp * 16) * stride;
    if constexpr (kTma) {
      tile_scores_wgmma<KS>(sc, qf, kt, d16 / 16, a.scale);
    } else if constexpr (kMma) {
      tile_scores<KS, kQRegs>(sc, qf, qw, kt, stride, d16 / 16, a.scale);
    } else {
      tile_scores_f32(sc, qw, kt, stride, a.D, a.scale);
    }
    // a tile whose every key is valid for every row of the warp skips the
    // mask test (all but the diagonal and window-edge tiles under causal)
    const int qw0 = r0 + warp * 16 + (a.Skv - a.Sq);
    const bool full = kb + kKeys <= a.Skv &&
                      (!a.causal || (kb + kKeys - 1 <= qw0 &&
                                     (a.window == 0 || qw0 + 15 - kb < a.window)));
    auto per_element = [&](auto full_tag) {
      constexpr bool kFull = decltype(full_tag)::value;
      auto ok = [&](int kpos, int h) { return kFull || valid_key(kpos, qpos0 + 8 * h, a); };
      // the exp code of score (n, e), 0 where masked
      auto exp_code = [&](int n, int e, int kpos) {
        const int h = e >> 1;
        if (!ok(kpos, h)) return 0;
        const int idx = alg1_exp_index_rcp(sc[n][e], m[h], off[h], rcp_s, c);
        return TABLE ? table[idx] : alg1_exp(-idx, c);
      };
      if (pass == 0) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, kpos = kb + 8 * n + 2 * tq + (e & 1);
            if (ok(kpos, h)) m[h] = fmaxf(m[h], sc[n][e]);
            const int r = r0 + warp * 16 + g + 8 * h;
            if (scores_out != nullptr && r < a.Sq && kpos < a.Skv)
              scores_out[(static_cast<size_t>(bh) * a.Sq + r) * a.Skv + kpos] = sc[n][e];
          }
      } else if (pass == 1) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e >> 1] += exp_code(n, e, kb + 8 * n + 2 * tq + (e & 1));
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, kpos = kb + 8 * n + 2 * tq + (e & 1);
            const float p = alg1_prob_row(exp_code(n, e, kpos), rd[h], c);
            const int r = r0 + warp * 16 + g + 8 * h;
            if (probs_out != nullptr && r < a.Sq && kpos < a.Skv)
              probs_out[(static_cast<size_t>(bh) * a.Sq + r) * a.Skv + kpos] = p;
            sc[n][e] = p;
          }
      }
    };
    if (full) {
      per_element(std::true_type{});
    } else {
      per_element(std::false_type{});
    }
    if (pass == 2) {  // P V
      if constexpr (kMma) {
        // P (rounded to bf16) from C to A fragments: keys 16 j .. 16 j + 15
        // are n tiles 2 j and 2 j + 1; B = V by ldmatrix.trans, two n
        // tiles of d at a time
        // (TMA: piece p of key r at p 1024 + r 16; else staged rows)
        const unsigned char* vrow =
            kTma ? vt + (lane & 15) * 16 + (lane >> 4) * 1024
                 : vt + static_cast<size_t>(lane & 15) * stride + (lane >> 4) * 16;
#pragma unroll
        for (int j = 0; j < kKeys / 16; ++j) {
          const unsigned pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                                  pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                                  pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                  pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
          for (int nd = 0; nd < kOT; nd += 2) {
            if (nd * 8 < d16) {
              unsigned b[4];
              ldsm_x4_trans(b, kTma ? vrow + 16 * j * 16 + nd * 1024
                                    : vrow + static_cast<size_t>(16 * j) * stride + nd * 16);
              const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
              mma_bf16(o[nd], pa, b0);
              mma_bf16(o[nd + 1], pa, b1);
            }
          }
        }
      } else {
        // key by key: the probabilities of rows g and g + 8 for key j sit
        // in lane 4 g + (j % 8) / 2 of the quad
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int src = (lane & ~3) | ((j & 7) >> 1);
          const float p0 = __shfl_sync(0xffffffffu, sc[j >> 3][j & 1], src);
          const float p1 = __shfl_sync(0xffffffffu, sc[j >> 3][2 + (j & 1)], src);
          const float* vr = reinterpret_cast<const float*>(vt + static_cast<size_t>(j) * stride);
#pragma unroll
          for (int nd = 0; nd < kOT; ++nd) {
            if (nd * 8 < a.D) {
              const float2 x = *reinterpret_cast<const float2*>(vr + nd * 8 + 2 * tq);
              o[nd][0] = fmaf(p0, x.x, o[nd][0]);
              o[nd][1] = fmaf(p0, x.y, o[nd][1]);
              o[nd][2] = fmaf(p1, x.x, o[nd][2]);
              o[nd][3] = fmaf(p1, x.y, o[nd][3]);
            }
          }
        }
      }
    }
  }

  // O: rows g and g + 8 of the warp, columns 8 nd + 2 t, + 1
#pragma unroll
  for (int nd = 0; nd < kOT; ++nd) {
    if (nd * 8 < a.D) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r < nr)
          *reinterpret_cast<float2*>(ob + static_cast<size_t>(r) * a.D + nd * 8 + 2 * tq) =
              make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
      }
    }
  }
}

// The TileMaps view of a [heads, rows, d] bf16 tensor at `base`: strides in
// bytes of rows, pieces and heads; boxes of `box_rows` rows by d16 / 8
// pieces.
int tile_map(CUtensorMap* map, const void* base, int heads, int rows, int d, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {8, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(d / 8),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2, 16,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(round_up(d, 16) / 8), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int KS, bool TABLE, int WARPS>
int launch(const void* q, const void* k, const void* v, float* out, float* scores_out,
           float* probs_out, const AttnShape& a, const Alg1Consts& c, cudaStream_t stream) {
  using C = Cta<T, KS, WARPS>;
  if (a.q_tile != C::kRows || a.k_tile != Tile<T>::kKeys)
    return static_cast<int>(cudaErrorInvalidValue);  // not the plan's tiles
  static int allowed = 48 * 1024;
  int optin = 0;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes<T, KS>(a.D, c.M);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(k3_attention<T, KS, TABLE, WARPS>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  TileMaps maps{};
  if (ScoresOnWgmma<T, KS>::value) {
    const int bkv = a.BH / a.group;
    if ((rc = tile_map(&maps.q, q, a.BH, a.Sq, a.D, C::kRows)) != 0 ||
        (rc = tile_map(&maps.k, k, bkv, a.Skv, a.D, Tile<T>::kKeys)) != 0 ||
        (rc = tile_map(&maps.v, v, bkv, a.Skv, a.D, Tile<T>::kKeys)) != 0)
      return rc;
  }
  const int n_qt = (a.Sq + C::kRows - 1) / C::kRows;
  k3_attention<T, KS, TABLE, WARPS><<<a.BH * n_qt, C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out,
      scores_out, probs_out, a, c, maps);
  return static_cast<int>(cudaGetLastError());
}

// k steps of the bf16 dots the kernel's registers hold: 8 (d <= 128, Q in
// registers) or 16; a smaller d runs the steps it has (fewer instances
// keep the build short).
int ks_bucket(int d) { return round_up(d, 16) <= 128 ? 8 : 16; }

// The plan's query tile picks the CTA: 128 rows (two warpgroups) only on
// the TMA path.
template <typename T, int KS, bool TABLE>
int launch_warps(const void* q, const void* k, const void* v, float* out, float* scores_out,
                 float* probs_out, const AttnShape& a, const Alg1Consts& c,
                 cudaStream_t stream) {
  if (ScoresOnWgmma<T, KS>::value && a.q_tile == Cta<T, KS, 8>::kRows)
    return launch<T, KS, TABLE, 8>(q, k, v, out, scores_out, probs_out, a, c, stream);
  return launch<T, KS, TABLE, 4>(q, k, v, out, scores_out, probs_out, a, c, stream);
}

template <typename T, int KS>
int launch_table(const void* q, const void* k, const void* v, float* out, float* scores_out,
                 float* probs_out, const AttnShape& a, const Alg1Consts& c,
                 cudaStream_t stream) {
  if (c.M <= kMaxTableM)
    return launch_warps<T, KS, true>(q, k, v, out, scores_out, probs_out, a, c, stream);
  return launch_warps<T, KS, false>(q, k, v, out, scores_out, probs_out, a, c, stream);
}

// Counts, into *mismatches, the f32 xs = x - m in [T_C, 0] whose exp index
// differs between alg1_exp_index (__fdiv_rn) and alg1_exp_index_rcp: every
// value the clamp lets through, so every (score, row max) pair.
__global__ void __launch_bounds__(256)
k3_division_check(Alg1Consts c, unsigned long long* mismatches) {
  const float rcp_s = __frcp_rn(c.S);
  const unsigned long long last = __float_as_uint(c.T_C);  // -0 .. T_C: 0x80000000 ..
  unsigned long long bad = 0;
  for (unsigned long long b = 0x80000000ull + blockIdx.x * 256ull + threadIdx.x; b <= last;
       b += gridDim.x * 256ull) {
    const float x = __uint_as_float(static_cast<unsigned>(b));
    bad += alg1_exp_index(x, 0.0f, 0, c) != alg1_exp_index_rcp(x, 0.0f, 0, rcp_s, c);
  }
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0 && bad != 0) atomicAdd(mismatches, bad);
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
      a.D > kMaxD || a.D % 8 != 0 || a.window < 0 || c.M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (a.k_tile != Tile<__nv_bfloat16>::kKeys) return static_cast<int>(cudaErrorInvalidValue);
    if (ks_bucket(a.D) == 8)
      return launch_table<__nv_bfloat16, 8>(q, k, v, out, scores_out, probs_out, a, c, st);
    return launch_table<__nv_bfloat16, 16>(q, k, v, out, scores_out, probs_out, a, c, st);
  }
  if (dtype == 1) {
    if (a.k_tile != Tile<float>::kKeys) return static_cast<int>(cudaErrorInvalidValue);
    return launch_table<float, 16>(q, k, v, out, scores_out, probs_out, a, c, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) of one launch of head dim d at score
// width M; 0 for an unknown dtype. chip_smoke.py holds it against
// ref.py:k3_smem_bytes.
extern "C" size_t int_attention_smem_bytes(int dtype, int d, int m) {
  if (dtype == 0) {
    return ks_bucket(d) == 8 ? smem_bytes<__nv_bfloat16, 8>(d, m)
                             : smem_bytes<__nv_bfloat16, 16>(d, m);
  }
  if (dtype == 1) return smem_bytes<float, 16>(d, m);
  return 0;
}

// Launch k3_division_check on `stream`, adding to the device counter
// *mismatches (the caller zeroes it); returns a CUDA error code.
extern "C" int int_attention_check_division(Alg1Consts c, unsigned long long* mismatches,
                                            void* stream) {
  k3_division_check<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(c, mismatches);
  return static_cast<int>(cudaGetLastError());
}
