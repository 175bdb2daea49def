// SoftmAP Algorithm 1 — the one CUDA __device__ body of the port.
//
// Counterpart of src/repro/core/alg1.py:int_softmax_block, the body every
// Pallas kernel of the reference traces. K1 (int_softmax.cu) includes it
// now; the fused attention kernels (K2, K3, K4) include it when they are
// ported, as all Pallas kernels share int_softmax_block.
//
// Per element, given the row's fp max and, later, the row's integer max and
// saturating sum:
//   quantize   v = clamp(rint((clamp(x - max, T_C, 0)) / S), -2^(M-1), 0)
//   exp        Barrett range reduction, (r + v_b)^2 + v_c, << (F - q)
//   divide     min((v_approx << P) / total, 2^P - 1)  ==  restoring division
//   dequant    q * 2^-P
// Every step is bit-identical to the plain PyTorch version
// (repro_torch/core/alg1.py) for the same f32 scores: IEEE division and
// round-half-even (no fast math), int32 arithmetic with both shift amounts
// clamped to <= 31, and an exact integer sum clipped once (the reference's
// pairwise saturating tree equals min(exact sum, saturation) in any order).
#pragma once

#include <cstdint>

// Offline constants of one PrecisionConfig (mirrored by ctypes in
// repro_torch/kernels/int_softmax/ops.py:Alg1Consts).
struct Alg1Consts {
  int M;            // score bit-width
  int P_out;        // fractional bits of the probability codes
  int v_ln2;        // floor(ln2 / S)
  int mu;           // Barrett constant floor(2^(2M) / v_ln2)
  int v_b;          // floor(b / S)
  int v_c;          // floor(c / (a S^2))
  int exp_shift;    // F
  int vcorr_min;    // -2^(w_vcorr - 1)
  int poly_sat;     // min(2^w_poly - 1, 2^31 - 1)
  int vapprox_sat;  // min(2^w_vapprox - 1, 2^31 - 1)
  int sum_sat;      // cfg.sum_saturation (<= 2^30 - 1)
  float T_C;        // clipping threshold (< 0)
  float S;          // quantization scale
};

#define ALG1_NEG_INF (-1e30f)

// fp score -> stabilized M-bit code (<= 0); row_max already guarded.
__device__ __forceinline__ int alg1_quantize(float x, float row_max,
                                             const Alg1Consts& c) {
  const float xs = fminf(fmaxf(x - row_max, c.T_C), 0.0f);
  const int v = __float2int_rn(__fdiv_rn(xs, c.S));
  return max(v, -(1 << (c.M - 1)));  // v <= 0 already
}

// Integer exponential: v_stable (<= 0, scale S) -> v_approx (scale aS^2).
__device__ __forceinline__ int alg1_exp(int v_stable, const Alg1Consts& c) {
  const int neg = -v_stable;
  int q = (neg * c.mu) >> (2 * c.M);
  int r = v_stable + q * c.v_ln2;
  if (r <= -c.v_ln2) {
    q += 1;
    r += c.v_ln2;
  }
  r = max(r, c.vcorr_min);
  const int t = r + c.v_b;
  const int poly = min(t * t + c.v_c, c.poly_sat);
  const int sh = c.exp_shift - min(q, 31 + c.exp_shift);
  const int va = sh >= 0 ? (poly << sh) : (poly >> min(-sh, 31));
  return min(va, c.vapprox_sat);
}

// Probability code -> float32: restoring-division semantics, so a lone
// element (v_approx == total) gives 2^P - 1, not 2^P.
__device__ __forceinline__ float alg1_prob(int v_approx, int total,
                                           const Alg1Consts& c) {
  const long long q = (static_cast<long long>(v_approx) << c.P_out) / total;
  const long long top = (1LL << c.P_out) - 1;
  const int code = static_cast<int>(q < top ? q : top);
  return scalbnf(__int2float_rn(code), -c.P_out);
}

// Block-wide reductions over blockDim.x threads (a multiple of 32); every
// thread returns the result. `scratch` holds 32 values in shared memory.
template <typename T, typename Op>
__device__ __forceinline__ T alg1_block_reduce(T v, Op op, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  const int nw = blockDim.x >> 5;
  for (int i = 1; i < nw; ++i) r = op(r, scratch[i]);
  return r;
}

struct Alg1MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Alg1MaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Alg1SumLL {
  __device__ long long operator()(long long a, long long b) const { return a + b; }
};
