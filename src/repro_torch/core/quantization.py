"""Quantization helpers for the integer-only softmax path (port of
``src/repro/core/quantization.py``: the Alg.-1 quantizer, the calibrated
absolute quantizer the AP dataflow validation uses, the EXAQ power-of-two
KV scales and the generic affine grid).

    x -> (x - max(x))      stabilization (shift-invariant)
      -> clip to [T_C, 0]  calibrated clipping (Sec. V-A)
      -> round(x / S)      signed M-bit quantization, S = -T_C / 2^(M-1)

Bit-exactness with the reference rests on three details:

* ``torch.round`` rounds half to even, like ``jnp.round``;
* ``x / S`` must be a true IEEE division. PyTorch's CUDA division by a
  Python (CPU) scalar multiplies by the reciprocal instead, which can move a
  code by one, so ``S`` is divided as a 0-dim tensor on the data's device
  (made by a fill, so the function stays capturable in a CUDA graph);
* fully masked rows get ``NEG_INF`` scores and a guarded row max of 0.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import PrecisionConfig

NEG_INF = -1e30


def quantize_stable_scores(x, cfg: PrecisionConfig, mask=None, axis: int = -1):
    """fp scores -> stabilized, clipped, signed-M-bit int32 codes (<= 0).

    ``mask``: optional bool tensor broadcastable to ``x``; True = valid.
    Invalid positions quantize to the clipping floor and are zeroed
    downstream (``alg1.int_softmax_from_codes``)."""
    x = x.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, NEG_INF)
    row_max = torch.amax(x, dim=axis, keepdim=True)
    # Guard fully-masked rows (row_max == NEG_INF): stabilized values become
    # 0, they are zeroed by the mask later.
    row_max = torch.where(row_max <= NEG_INF, 0.0, row_max)
    return quantize_against(x, row_max, cfg)


def quantize_against(x, row_max, cfg: PrecisionConfig):
    """f32 scores -> signed M-bit codes (<= 0) against an already guarded
    row max (broadcastable to ``x``): clip ``x - row_max`` to [T_C, 0],
    divide by S, round half to even."""
    x_stable = torch.clamp(x - row_max, cfg.T_C, 0.0)
    s = torch.full((), cfg.S, dtype=torch.float32, device=x.device)
    v = torch.round(x_stable / s).to(torch.int32)
    # round() at the clip floor can land exactly on -2^(M-1); keep in range.
    return torch.clamp(v, -(2 ** (cfg.M - 1)), 0)


def quantize_raw_scores(x, cfg: PrecisionConfig, calib_max: float, axis: int = -1):
    """Absolute (calibrated) quantization: codes share the grid of ``S`` but
    are offset by a calibrated maximum, so the integer max-subtract of Alg. 1
    line 4 does real work. Used by tests and the AP dataflow validation."""
    x = x.to(torch.float32)
    lo = calib_max + cfg.T_C
    x = torch.clamp(x, lo, calib_max)
    s = torch.full((), cfg.S, dtype=torch.float32, device=x.device)
    return torch.round(x / s).to(torch.int32)


def dequantize_probs(p_codes, cfg: PrecisionConfig):
    """Fixed-point probability codes -> float32 probabilities."""
    return p_codes.to(torch.float32) * (2.0 ** (-cfg.P_out))


# ---- EXAQ-style exponent-aware KV scales (arxiv 2410.03185) ------------------
#
# scale = 2^ceil(log2(max(amax / 127, floor))) per KV position and head: a
# power of two, so dequantization is an exponent add, and a function of that
# position's amax alone (position-local, which keeps shared and chunked int8
# blocks bit-identical). The exponent is read from the f32 bits and the power
# of two built from them, in integer arithmetic: the result is exact and the
# same on every device. The reference evaluates ``exp2(ceil(log2(s)))`` with
# XLA's transcendental functions, which are inexact on this grid at a few
# points: ``log2`` within an ulp of a power of two (so ``ceil`` can land one
# exponent off) and ``exp2`` of integers below -12. There the two differ by
# one power of two, or by a few ulps of the scale (tests/test_torch_kvquant.py).

# ``amax / 127.0`` in the reference's compiled graph: XLA rewrites a
# division by a constant into a multiplication by its f32 reciprocal.
KV_RECIP_127 = 1.0 / 127.0


def _ceil_log2(s):
    """ceil(log2(s)) of positive normal f32 ``s``, exactly (int32)."""
    bits = s.contiguous().view(torch.int32)
    return (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)


def _pow2(e):
    """2^e as f32 for int32 ``e`` in the normal range [-126, 127], exactly."""
    return ((e + 127) << 23).view(torch.float32)


def exaq_scale(amax, floor: float = 1e-8):
    """Power-of-two KV scale per EXAQ: smallest 2^e with 127 * 2^e >= amax."""
    s = torch.clamp_min(amax.to(torch.float32) * KV_RECIP_127, floor)
    return _pow2(_ceil_log2(s))


def exaq_scale_clamped(amax, exp_bits: int, floor: float = 1e-8):
    """EXAQ scale with the exponent clamped to a signed ``exp_bits`` field
    (saturating at -2^(exp_bits-1) and 2^(exp_bits-1) - 1): the scale word
    an exponent-add datapath would carry. Still position-local."""
    s = torch.clamp_min(amax.to(torch.float32) * KV_RECIP_127, floor)
    lo, hi = -(2 ** (exp_bits - 1)), 2 ** (exp_bits - 1) - 1
    return _pow2(torch.clamp(_ceil_log2(s), lo, hi))


# ---- generic affine quantizer ------------------------------------------------


def affine_qparams(lo: float, hi: float, bits: int, symmetric: bool = False):
    """Return (scale, zero_point) for an affine integer grid."""
    if symmetric:
        amax = max(abs(lo), abs(hi))
        scale = amax / float(2 ** (bits - 1) - 1)
        return scale, 0
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    scale = (hi - lo) / float(qmax - qmin)
    zero = round(qmin - lo / scale) if scale > 0 else 0
    return scale, int(zero)


def affine_quantize(x, scale: float, zero: int, bits: int):
    """Round-half-even of ``x / scale`` (a true division by the f32 scale)
    plus ``zero``, clipped to the signed ``bits`` grid, as int32."""
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    s = torch.full((), scale, dtype=torch.float32, device=x.device)
    q = torch.round(x.to(torch.float32) / s) + zero
    return torch.clamp(q, qmin, qmax).to(torch.int32)


def affine_dequantize(q, scale: float, zero: int):
    return (q - zero).to(torch.float32) * scale
