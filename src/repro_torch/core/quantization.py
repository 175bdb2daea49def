"""Quantization helpers for the integer-only softmax path (port of
``src/repro/core/quantization.py``: the Alg.-1 subset).

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
    x_stable = torch.clamp(x - row_max, cfg.T_C, 0.0)
    s = torch.full((), cfg.S, dtype=torch.float32, device=x.device)
    v = torch.round(x_stable / s).to(torch.int32)
    # round() at the clip floor can land exactly on -2^(M-1); keep in range.
    return torch.clamp(v, -(2 ** (cfg.M - 1)), 0)


def dequantize_probs(p_codes, cfg: PrecisionConfig):
    """Fixed-point probability codes -> float32 probabilities."""
    return p_codes.to(torch.float32) * (2.0 ** (-cfg.P_out))
