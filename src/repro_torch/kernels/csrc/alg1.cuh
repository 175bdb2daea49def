// SoftmAP Algorithm 1 — the one CUDA __device__ body of the port.
//
// Counterpart of src/repro/core/alg1.py:int_softmax_block, the body every
// Pallas kernel of the reference traces. K1 (int_softmax.cu), K2
// (paged_attention.cu), K3 (int_attention.cu) and K4 (paged_attention_mla.cu)
// include it, as all Pallas kernels share int_softmax_block.
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

// alg1_prob by one double division and an exact integer correction: the
// same code for every input. num = v_approx 2^P < 2^61 and total are exact
// doubles, so the rounded quotient q' is within q 2^-52 < 1 of q = num /
// total while q <= 2^P + 1 (P <= 30); its truncation is then floor(q) - 1,
// floor(q) or floor(q) + 1, which the remainder num - q' total (exact in
// int64) puts right. A larger q' means q > 2^P - 1: the code is 2^P - 1
// either way. On the H100 it is the faster form in K4, which takes each
// probability once per latent column group; K1 divides a whole row by one
// total and takes alg1_prob_row below (PERF.md §6).
__device__ __forceinline__ float alg1_prob_fast(int v_approx, int total,
                                                const Alg1Consts& c) {
  const long long num = static_cast<long long>(v_approx) << c.P_out;
  const long long top = (1LL << c.P_out) - 1;
  long long q = static_cast<long long>(
      __ddiv_rn(static_cast<double>(num), static_cast<double>(total)));
  if (q <= top + 1) {
    const long long rem = num - q * total;
    q += rem < 0 ? -1 : (rem >= total ? 1 : 0);
  }
  const int code = static_cast<int>(q < top ? q : top);
  return scalbnf(__int2float_rn(code), -c.P_out);
}

// alg1_prob for a row whose total is fixed, by a reciprocal taken once per
// row (alg1_row_div) and 32-bit arithmetic per element (alg1_prob_row): the
// same code for every input. With T = total (1 <= T < 2^30), P = P_out <=
// 30 and R = floor(2^(P+32) / T) = r_hi 2^32 + r_lo, a v < T gives
//   y = v r_hi + floor(v r_lo / 2^32)
// with y <= v 2^P / T < y + 1 + v / 2^32 < y + 1.25, so y is q or q - 1
// for q = floor(v 2^P / T) < 2^P; the remainder v 2^P - y T lies in
// [0, 1.25 T) and so is exact in 32-bit wrap-around arithmetic, and
// y + (remainder >= T) is q. A v >= T gives 2^P - 1, as alg1_prob does
// (v == T is a lone element, v > T a saturated sum).
struct Alg1RowDiv {
  unsigned total, r_hi, r_lo;
};

__device__ __forceinline__ Alg1RowDiv alg1_row_div(int total, const Alg1Consts& c) {
  const unsigned t = static_cast<unsigned>(total);
  const unsigned long long r = (1ULL << (c.P_out + 32)) / t;
  return {t, static_cast<unsigned>(r >> 32), static_cast<unsigned>(r)};
}

__device__ __forceinline__ float alg1_prob_row(int v_approx, const Alg1RowDiv& d,
                                               const Alg1Consts& c) {
  const unsigned v = static_cast<unsigned>(v_approx);
  unsigned q = v * d.r_hi + __umulhi(v, d.r_lo);
  q += (v << c.P_out) - q * d.total >= d.total ? 1u : 0u;
  const unsigned code = v >= d.total ? (1u << c.P_out) - 1u : q;
  // code * 2^-P_out: exact, as scalbnf (a normal result or 0)
  return __int2float_rn(static_cast<int>(code)) * __int_as_float((127 - c.P_out) << 23);
}

// The row's divisor from its exact integer sum: total = max(min(sum,
// sum_sat), 1), the reference's saturating tree in any order.
__device__ __forceinline__ Alg1RowDiv alg1_sum_div(long long sum, const Alg1Consts& c) {
  const long long clipped = sum < c.sum_sat ? sum : c.sum_sat;
  return alg1_row_div(clipped > 1 ? static_cast<int>(clipped) : 1, c);
}

// A split row (K1's clusters, K3's key tiles) needs no integer max pass: the
// integer row max is the code of the fp row max, 0 for a row with a valid
// score above ALG1_NEG_INF (quantize is monotone). Where every valid score
// is at or below it, the guarded max 0 puts them all on the floor code and
// their stable codes are 0. alg1_guard turns the fp row max m over valid
// scores into the guarded max and `off`, the integer max's distance below 0
// (0, or 2^(M-1) in a guarded row).
__device__ __forceinline__ void alg1_guard(float& m, int& off, const Alg1Consts& c) {
  const bool guarded = m <= ALG1_NEG_INF;
  off = guarded ? 1 << (c.M - 1) : 0;
  m = guarded ? 0.0f : m;
}

// -v_stable = -(alg1_quantize(x, m) - vmax) for the guarded max m and `off`
// of alg1_guard, clamped at 0 (an invalid score may sit above a guarded
// row's floor; its exp code is dropped). rint is the 1.5 * 2^23 magic add:
// round-half-even in the add, exact while |x - m| / S <= 2^22, and
// (x - m) / S >= T_C / S = -2^(M-1) needs no floor clamp.
__device__ __forceinline__ int alg1_exp_index(float x, float m, int off, const Alg1Consts& c) {
  const float xs = fminf(fmaxf(x - m, c.T_C), 0.0f);
  const float q = __fadd_rn(__fdiv_rn(xs, c.S), 12582912.0f);  // rint(xs / S) + 1.5 2^23
  return max(0x4B400000 - __float_as_int(q) - off, 0);
}

// alg1_exp_index with the division by S as a product by y = RN(1/S)
// (__frcp_rn, once a thread) and one FMA correction, with no branch
// (__fdiv_rn carries a slow-path branch per element). Markstein's theorem:
// y within half an ulp of 1/S and q0 = RN(xs y) within an ulp of xs / S
// make r = xs - q0 S exact and RN(q0 + r y) = RN(xs / S), barring
// underflow, which only |xs / S| < 2^-100 meets, and those give code 0
// either way. K3's wrapper checks it against alg1_exp_index on the card
// over every f32 in [T_C, 0] (int_attention_check_division).
__device__ __forceinline__ int alg1_exp_index_rcp(float x, float m, int off, float rcp_s,
                                                  const Alg1Consts& c) {
  const float xs = fminf(fmaxf(x - m, c.T_C), 0.0f);
  const float q0 = __fmul_rn(xs, rcp_s);
  const float q = __fmaf_rn(__fmaf_rn(-c.S, q0, xs), rcp_s, q0);
  return max(0x4B400000 - __float_as_int(__fadd_rn(q, 12582912.0f)) - off, 0);
}

// table[i] = alg1_exp(-i) for the 2^(M-1) + 1 stable codes -i, built by the
// block's threads (TABLE false: nothing; the caller computes alg1_exp).
template <bool TABLE>
__device__ __forceinline__ void alg1_build_table(int* table, const Alg1Consts& c) {
  if (!TABLE) return;
  for (int i = threadIdx.x; i <= (1 << (c.M - 1)); i += blockDim.x) table[i] = alg1_exp(-i, c);
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
