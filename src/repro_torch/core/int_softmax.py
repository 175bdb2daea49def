"""Softmax variants on top of the Alg.-1 body (port of
``src/repro/core/int_softmax.py``): the integer softmax at the float
boundary, its straight-through training variant, and the floating-point
baselines used in ablations."""

from __future__ import annotations

import torch

from repro_torch.core.alg1 import int_softmax_from_codes
from repro_torch.core.precision import BEST, PrecisionConfig
from repro_torch.core.quantization import NEG_INF, dequantize_probs, quantize_stable_scores


def int_softmax(x, cfg: PrecisionConfig = BEST, mask=None, axis: int = -1):
    """End-to-end integer softmax: float scores -> float32 probabilities,
    with ``div="auto"`` exactly as the reference."""
    v = quantize_stable_scores(x, cfg, mask=mask, axis=axis)
    codes = int_softmax_from_codes(v, cfg, mask=mask, axis=axis,
                                   assume_stable=True)
    return dequantize_probs(codes, cfg)


class _IntSoftmaxSTE(torch.autograd.Function):
    """Integer forward, fp-softmax Jacobian backward."""

    @staticmethod
    def forward(ctx, x, cfg, mask, axis):
        ctx.save_for_backward(x)
        ctx.mask, ctx.axis = mask, axis
        return int_softmax(x, cfg, mask=mask, axis=axis)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            t = x.detach().requires_grad_(True)
            y = fp_softmax(t, mask=ctx.mask, axis=ctx.axis)
            (gx,) = torch.autograd.grad(y, t, g)
        return gx, None, None, None


def int_softmax_ste(x, cfg: PrecisionConfig = BEST, mask=None, axis: int = -1):
    """Quantization-aware-training variant: integer softmax forward, FP
    softmax gradient backward (straight-through estimator). The mask gets
    no gradient."""
    return _IntSoftmaxSTE.apply(x, cfg, mask, axis)


def fp_softmax(x, mask=None, axis: int = -1):
    """Floating-point reference softmax (with the same masking semantics)."""
    x = x.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, NEG_INF)
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    e = torch.exp(x - m)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return e / torch.clamp_min(torch.sum(e, dim=axis, keepdim=True), 1e-30)


def fp_softmax_lowp(x, mask=None, axis: int = -1):
    """Low-precision softmax: elementwise tensors stay in the input dtype;
    only the sum accumulates in f32."""
    if mask is not None:
        x = torch.where(mask, x, torch.tensor(-30000.0, dtype=x.dtype,
                                              device=x.device))
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    e = torch.exp(x - m)
    if mask is not None:
        e = torch.where(mask, e, torch.zeros((), dtype=x.dtype, device=x.device))
    s = torch.sum(e.to(torch.float32), dim=axis, keepdim=True)
    return e / torch.clamp_min(s, 1e-30).to(e.dtype)


def clipped_fp_softmax(x, t_c: float, mask=None, axis: int = -1):
    """FP softmax with SoftmAP's input clipping only — isolates the clipping
    error from the integer-approximation error in ablations."""
    x = x.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, NEG_INF)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(torch.clamp(x - m, t_c, 0.0))
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return e / torch.clamp_min(torch.sum(e, dim=axis, keepdim=True), 1e-30)
