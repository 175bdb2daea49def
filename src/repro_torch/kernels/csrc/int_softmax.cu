// K1 on Hopper: SoftmAP Alg. 1 over the last axis of [rows, cols] f32
// scores, with an optional [rows, cols] uint8 mask (nonzero = valid).
//
// Replaces the TPU kernel src/repro/kernels/int_softmax/kernel.py:43
// (int_softmax_kernel, bodies _kernel / _kernel_masked) behind the
// int_pallas softmax backend. The per-element arithmetic is alg1.cuh.
//
// Bound on an H100: memory. Each element is read once (4 B score + 1 B
// mask) and written once (4 B probability), so the least time is
// rows * cols * (4 + 4 + 1) B over the HBM rate; the integer work is a few
// tens of ALU operations per element, well under the card's ALU rate.
//
// Design (simple first): one CTA per row, 256 threads striding the row.
//   pass 1  fp row max over valid scores (block reduction)
//   pass 2  M-bit codes into dynamic shared memory + integer row max
//   pass 3  integer exp codes in place + exact int64 row sum, clipped once
//   pass 4  division to P_out bits and dequantization, written out
// The row's codes never leave shared memory (cols * 4 B, <= 128 KB at the
// 32768-column limit, within the 227 KB a block may use), so HBM traffic is
// the bound's plus one re-read of the scores in pass 2 (mostly L2 hits).
// Rows are independent, so there is no cross-CTA reduction.
#include <cstdint>

#include <cuda_runtime.h>

#include "alg1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 32768;

__global__ void __launch_bounds__(kThreads)
int_softmax_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int cols, Alg1Consts c) {
  extern __shared__ int codes[];
  __shared__ float s_max_f[32];
  __shared__ int s_max_i[32];
  __shared__ long long s_sum[32];

  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const float* xr = x + base;
  const uint8_t* mr = mask == nullptr ? nullptr : mask + base;
  float* orow = out + base;

  float m = ALG1_NEG_INF;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    m = fmaxf(m, (mr == nullptr || mr[j]) ? xr[j] : ALG1_NEG_INF);
  }
  m = alg1_block_reduce(m, Alg1MaxF(), s_max_f);
  if (m <= ALG1_NEG_INF) m = 0.0f;  // fully masked row

  const int floor_code = -(1 << (c.M - 1));
  int vmax = floor_code;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int v = (mr == nullptr || mr[j]) ? alg1_quantize(xr[j], m, c) : floor_code;
    codes[j] = v;
    vmax = max(vmax, v);
  }
  vmax = alg1_block_reduce(vmax, Alg1MaxI(), s_max_i);

  long long sum = 0;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int va = (mr == nullptr || mr[j]) ? alg1_exp(codes[j] - vmax, c) : 0;
    codes[j] = va;
    sum += va;
  }
  sum = alg1_block_reduce(sum, Alg1SumLL(), s_sum);
  const long long clipped = sum < c.sum_sat ? sum : c.sum_sat;
  const int total = clipped > 1 ? static_cast<int>(clipped) : 1;

  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    orow[j] = alg1_prob(codes[j], total, c);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller allocates `out` and checks shapes (ops.py:int_softmax_rows).
extern "C" int int_softmax_launch(const float* x, const uint8_t* mask, float* out,
                                  int rows, int cols, Alg1Consts c, void* stream) {
  if (rows < 1 || cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        int_softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxCols * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opt_in = true;
  }
  const size_t smem = static_cast<size_t>(cols) * sizeof(int);
  int_softmax_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mask, out, cols, c);
  return static_cast<int>(cudaGetLastError());
}
