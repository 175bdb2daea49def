// K1 on Hopper: SoftmAP Alg. 1 over the last axis of [rows, cols] f32
// scores, with an optional [rows, cols] uint8 mask (nonzero = valid).
//
// Replaces the TPU kernel src/repro/kernels/int_softmax/kernel.py:43
// (int_softmax_kernel, bodies _kernel / _kernel_masked) behind the
// int_pallas softmax backend. The per-element arithmetic is alg1.cuh.
//
// Bound on an H100: memory, with the ALU close behind. Each element is read
// once (4 B score + 1 B mask) and written once (4 B probability): rows *
// cols * 9 B over the HBM rate, about 1.4 elements per SM and clock. At that
// rate an SM has some 90 thread-instructions an element, fewer for integer
// ones, so the design keeps the per-element work short:
//   * the row lives in registers: each thread holds `E` elements (float4
//     score and 4-byte mask loads where the row allows, else scalar), read
//     once and written once, with no shared-memory round trip;
//   * the integer row max is not reduced: it is the code of the fp row max,
//     0 for a row with a valid score above ALG1_NEG_INF (quantize is
//     monotone); where every valid score is at or below it the guarded max 0
//     puts them all on the floor code, and their stable codes are 0;
//   * the exponential is a table of the 2^(M-1) + 1 stable codes in shared
//     memory, built per CTA by alg1_exp (M <= 14; a larger M, outside the
//     paper's configs, takes alg1_exp per element and scalar loads);
//   * rint is the 1.5 * 2^23 magic add (round-half-even in the add, |q| <=
//     2^15), not a conversion;
//   * the division by the row's total is alg1_prob_row (a reciprocal per
//     row, 32-bit multiplies per element).
//
// Two layouts, chosen by the host plan (kernels/int_softmax/ref.py:
// k1_split_plan); each is one launch:
//   rows   cols <= 2048: a warp per row, 1-8 rows per CTA, E = 4..64 per
//          lane; the fp max and the int64 sum by warp shuffles, no
//          __syncthreads after the table.
//   split  longer rows: a thread-block cluster of C <= 8 CTAs per row,
//          each CTA a chunk of 512 * E columns (E = 4..32). Alg. 1 splits
//          exactly: chunk maxima -> row max and chunk int64 sums -> row sum
//          through distributed shared memory, then the elementwise division.
#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_runtime.h>

#include "alg1.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSplitThreads = 512;
constexpr int kMaxM = 14;          // largest table: 2^13 + 1 codes, 32 KB (no opt-in)
constexpr int kMaxCluster = 8;     // portable; 16 (non-portable) read slower (PERF.md §6)

// One thread's E elements of a row's chunk [begin, end). VEC: element e is
// column begin + 4 (t + stride (e / 4)) + e % 4 (a float4 and a 4-byte mask
// word a step); else column begin + t + stride e. valid[e / 4] holds the
// mask bytes of elements 4 (e / 4) .. + 3 (0 outside the row).
template <int E, bool VEC>
struct Slice {
  float x[E];
  unsigned valid[E / 4];

  static __device__ __forceinline__ int col(int begin, int t, int stride, int e) {
    return VEC ? begin + 4 * (t + stride * (e / 4)) + e % 4 : begin + t + stride * e;
  }

  __device__ __forceinline__ bool ok(int e) const {
    return (valid[e / 4] >> (8 * (e % 4))) & 0xffu;
  }

  __device__ __forceinline__ void load(const float* __restrict__ xr,
                                       const uint8_t* __restrict__ mr, int begin, int end,
                                       int t, int stride) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      if (VEC) {
        const int j = col(begin, t, stride, 4 * i);
        if (j < end) {  // end and j are multiples of 4
          const float4 v = *reinterpret_cast<const float4*>(xr + j);
          x[4 * i] = v.x;
          x[4 * i + 1] = v.y;
          x[4 * i + 2] = v.z;
          x[4 * i + 3] = v.w;
          valid[i] = mr == nullptr ? 0x01010101u : *reinterpret_cast<const unsigned*>(mr + j);
        } else {
          x[4 * i] = x[4 * i + 1] = x[4 * i + 2] = x[4 * i + 3] = 0.0f;
          valid[i] = 0u;
        }
      } else {
        valid[i] = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = col(begin, t, stride, 4 * i + k);
          x[4 * i + k] = j < end ? xr[j] : 0.0f;
          const unsigned m = j < end ? (mr == nullptr ? 1u : mr[j]) : 0u;
          valid[i] |= (m ? 1u : 0u) << (8 * k);
        }
      }
    }
  }

  __device__ __forceinline__ float max_valid() const {
    float m = ALG1_NEG_INF;
#pragma unroll
    for (int e = 0; e < E; ++e) m = fmaxf(m, ok(e) ? x[e] : ALG1_NEG_INF);
    return m;
  }

  // Exp codes into x (as int bits), against the guarded row max `m`; `off`
  // is the integer row max's distance below 0 (0, or 2^(M-1) in a guarded
  // row). TABLE: looked up in `table`, else computed. Returns their exact sum.
  template <bool TABLE>
  __device__ __forceinline__ long long exp_codes(float m, int off, const int* table,
                                                 const Alg1Consts& c) {
    long long sum = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = alg1_exp_index(x[e], m, off, c);
      const int va = ok(e) ? (TABLE ? table[idx] : alg1_exp(-idx, c)) : 0;
      sum += va;
      x[e] = __int_as_float(va);
    }
    return sum;
  }

  __device__ __forceinline__ void store(float* __restrict__ orow, int begin, int end, int t,
                                        int stride, const Alg1RowDiv& d, const Alg1Consts& c) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#ifdef K1_INT64_DIVISION  // the per-element int64 division, for same-call timing
        p[k] = alg1_prob(__float_as_int(x[4 * i + k]), static_cast<int>(d.total), c);
#else
        p[k] = alg1_prob_row(__float_as_int(x[4 * i + k]), d, c);
#endif
      }
      if (VEC) {
        const int j = col(begin, t, stride, 4 * i);
        if (j < end) *reinterpret_cast<float4*>(orow + j) = make_float4(p[0], p[1], p[2], p[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = col(begin, t, stride, 4 * i + k);
          if (j < end) orow[j] = p[k];
        }
      }
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ rows layout

template <int E, bool VEC, bool TABLE>
__global__ void __launch_bounds__(256)
k1_rows(const float* __restrict__ x, const uint8_t* __restrict__ mask,
        float* __restrict__ out, int rows, int cols, Alg1Consts c) {
  extern __shared__ int table[];
  alg1_build_table<TABLE>(table, c);
  __syncthreads();
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(row) * cols;
  const uint8_t* mr = mask == nullptr ? nullptr : mask + base;

  Slice<E, VEC> s;
  s.load(x + base, mr, 0, cols, lane, 32);
  float m = warp_max(s.max_valid());
  int off;
  alg1_guard(m, off, c);
  const long long sum = warp_sum(s.template exp_codes<TABLE>(m, off, table, c));
  s.store(out + base, 0, cols, lane, 32, alg1_sum_div(sum, c), c);
}

// ----------------------------------------------------------- split layout

// Combine of the cluster's CTA values `mine` (one per CTA, in shared
// memory): each lane below the cluster size reads one CTA's through
// distributed shared memory; every thread returns the combined value.
template <typename T, typename Op>
__device__ __forceinline__ T cluster_combine(cg::cluster_group& cluster, T* mine, T init,
                                             Op op) {
  const unsigned lane = threadIdx.x & 31;
  T v = lane < cluster.num_blocks() ? *cluster.map_shared_rank(mine, lane) : init;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One row per cluster (consecutive blockIdx.x), CTA `rank` on columns
// [rank * chunk, (rank + 1) * chunk).
template <int E, bool VEC, bool TABLE>
__global__ void __launch_bounds__(kSplitThreads)
k1_split(const float* __restrict__ x, const uint8_t* __restrict__ mask,
         float* __restrict__ out, int cols, Alg1Consts c) {
  extern __shared__ int table[];
  __shared__ float part_max[32];
  __shared__ long long part_sum[32];
  __shared__ float cta_max;
  __shared__ long long cta_sum;
  cg::cluster_group cluster = cg::this_cluster();
  alg1_build_table<TABLE>(table, c);

  const int row = blockIdx.x / cluster.num_blocks();
  const int begin = cluster.block_rank() * kSplitThreads * E;
  const int end = min(begin + kSplitThreads * E, cols);
  const size_t base = static_cast<size_t>(row) * cols;
  const uint8_t* mr = mask == nullptr ? nullptr : mask + base;

  Slice<E, VEC> s;
  s.load(x + base, mr, begin, end, threadIdx.x, kSplitThreads);
  // pass 1: chunk maxima -> the row max
  float m = alg1_block_reduce(s.max_valid(), Alg1MaxF(), part_max);
  if (threadIdx.x == 0) cta_max = m;
  cluster.sync();  // also publishes the table
  m = cluster_combine(cluster, &cta_max, ALG1_NEG_INF, Alg1MaxF());
  int off;
  alg1_guard(m, off, c);
  // pass 2: chunk int64 sums -> the row sum, clipped once
  long long sum =
      alg1_block_reduce(s.template exp_codes<TABLE>(m, off, table, c), Alg1SumLL(), part_sum);
  if (threadIdx.x == 0) cta_sum = sum;
  cluster.sync();
  sum = cluster_combine(cluster, &cta_sum, 0LL, Alg1SumLL());
  // no CTA leaves while another may still read its shared memory
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  // pass 3: the division
  s.store(out + base, begin, end, threadIdx.x, kSplitThreads, alg1_sum_div(sum, c), c);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------------ host

size_t table_bytes(int M) { return M > kMaxM ? 0 : ((1u << (M - 1)) + 1) * sizeof(int); }

template <int E, bool VEC, bool TABLE>
cudaError_t launch_rows(const float* x, const uint8_t* mask, float* out, int rows, int cols,
                        int rows_per_cta, Alg1Consts c, cudaStream_t stream) {
  const size_t smem = table_bytes(c.M);
  const int grid = (rows + rows_per_cta - 1) / rows_per_cta;
  k1_rows<E, VEC, TABLE><<<grid, 32 * rows_per_cta, smem, stream>>>(x, mask, out, rows, cols, c);
  return cudaGetLastError();
}

template <int E, bool VEC, bool TABLE>
cudaError_t launch_split(const float* x, const uint8_t* mask, float* out, int rows, int cols,
                         int cluster, Alg1Consts c, cudaStream_t stream) {
  const size_t smem = table_bytes(c.M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * cluster);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k1_split<E, VEC, TABLE>, x, mask, out, cols, c);
}

template <bool VEC, bool TABLE>
cudaError_t dispatch(const float* x, const uint8_t* mask, float* out, int rows, int cols,
                     int per_thread, int rows_per_cta, int cluster, Alg1Consts c,
                     cudaStream_t s) {
  if (cluster == 1) {
    switch (per_thread) {
      case 4: return launch_rows<4, VEC, TABLE>(x, mask, out, rows, cols, rows_per_cta, c, s);
      case 8: return launch_rows<8, VEC, TABLE>(x, mask, out, rows, cols, rows_per_cta, c, s);
      case 16: return launch_rows<16, VEC, TABLE>(x, mask, out, rows, cols, rows_per_cta, c, s);
      case 32: return launch_rows<32, VEC, TABLE>(x, mask, out, rows, cols, rows_per_cta, c, s);
      case 64: return launch_rows<64, VEC, TABLE>(x, mask, out, rows, cols, rows_per_cta, c, s);
    }
  } else {
    switch (per_thread) {
      case 4: return launch_split<4, VEC, TABLE>(x, mask, out, rows, cols, cluster, c, s);
      case 8: return launch_split<8, VEC, TABLE>(x, mask, out, rows, cols, cluster, c, s);
      case 16: return launch_split<16, VEC, TABLE>(x, mask, out, rows, cols, cluster, c, s);
      case 32: return launch_split<32, VEC, TABLE>(x, mask, out, rows, cols, cluster, c, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch the layout of the host plan (ref.py:k1_split_plan) on `stream`:
// cluster 1 is the rows layout (a warp a row, rows_per_cta in {1, 2, 4, 8},
// per_thread in {4, ..., 64}, 32 * per_thread >= cols); cluster 2-8 the
// split layout (per_thread in {4, ..., 32}, each of the cluster's CTAs on
// 512 * per_thread columns, the last one reaching cols). Returns a CUDA
// error code (0 on success); the caller allocates `out` and checks shapes
// (ops.py:int_softmax_rows).
extern "C" int int_softmax_launch(const float* x, const uint8_t* mask, float* out, int rows,
                                  int cols, int per_thread, int rows_per_cta, int cluster,
                                  Alg1Consts c, void* stream) {
  const long long span = static_cast<long long>(cluster == 1 ? 32 : kSplitThreads) * per_thread;
  const bool shape_ok =
      rows >= 1 && cols >= 1 && c.M >= 2 && cluster >= 1 &&
      cluster <= kMaxCluster && span * cluster >= cols && span * (cluster - 1) < cols &&
      (cluster > 1 || rows_per_cta == 1 || rows_per_cta == 2 || rows_per_cta == 4 ||
       rows_per_cta == 8) &&
      (cluster == 1 || static_cast<long long>(rows) * cluster <= 0x7fffffffLL);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  // float4 scores and 4-byte mask words where every row starts aligned (and
  // the exp table fits; a larger M, outside the paper's configs, is scalar)
  const bool vec = c.M <= kMaxM && cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec            ? dispatch<true, true>(x, mask, out, rows, cols, per_thread, rows_per_cta,
                                            cluster, c, s)
      : c.M <= kMaxM ? dispatch<false, true>(x, mask, out, rows, cols, per_thread, rows_per_cta,
                                             cluster, c, s)
                     : dispatch<false, false>(x, mask, out, rows, cols, per_thread,
                                              rows_per_cta, cluster, c, s);
  return static_cast<int>(err);
}
