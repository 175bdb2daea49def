"""SoftmAP Algorithm 1 — the plain PyTorch integer body (port of
``src/repro/core/alg1.py``).

  l.4   v_stable = v - max(v)                       (integer max-subtract)
  l.5-7 Barrett range reduction: q, v_corr in (-v_ln2, 0]
  l.8-11 v_approx = ((v_corr + v_b)^2 + v_c) << (F - q)   (shift clamped)
  l.12  v_sm     = v_approx / sum(v_approx)         (fixed-point division)

Every op is int32 tensor arithmetic, so the codes equal the reference's bit
for bit once the float scores going in are equal. The CUDA kernel under
``kernels/csrc/alg1.cuh`` computes the same body per element and is held
against this module bitwise.

Division contract (pinned by ``tests/test_torch_alg1.py`` for both
packages): the codes of :func:`int_softmax_from_codes` are
``floor(v_approx * 2^P / total)`` EXCEPT where ``v_approx == total`` (a lone
unmasked element, e.g. row 0 of every causal prefill):

* ``div="bitserial"`` (restoring long division, :func:`fixedpoint_div`)
  yields the all-ones code ``2^P - 1`` there;
* ``div="auto"`` takes the single-op fast path ``(v << P) // total`` when
  ``w_vapprox + P_out <= 31`` and then yields ``2^P``; at configs where the
  fast path does not fit (``BEST``: 12 + 24 = 36) it falls back to
  bitserial, and only there are the two modes bit-identical.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quantization import dequantize_probs, quantize_stable_scores


def _sat(x, width: int):
    """Saturate non-negative int32 values to ``width`` bits."""
    return torch.clamp_max(x, min(2**width - 1, 2**31 - 1))


def saturating_sum(x, saturation: int, axis: int = -1):
    """``min(sum(x), saturation)`` of non-negative int32 values.

    The reference realizes this as a pairwise saturating tree (the 2D AP's
    row reduction); that tree provably equals ``min(exact sum, saturation)``
    in any order, so the port sums exactly in int64 and clips once.
    ``saturation`` must be <= 2^30 - 1 (the reference's int32 bound)."""
    if saturation > 2**30 - 1:
        raise ValueError("saturation must be <= 2^30 - 1 to stay in int32")
    total = torch.sum(x, dim=axis, dtype=torch.int64)
    return torch.clamp_max(total, saturation).to(torch.int32)


def fixedpoint_div(num, den, frac_bits: int):
    """Restoring long division of ``num * 2^frac_bits`` by ``den`` for int32
    ``0 <= num <= den <= 2^30``; ``den`` broadcasts against ``num``.

    Equals ``floor(num * 2^P / den)`` for ``num < den`` and the all-ones code
    ``2^P - 1`` at ``num == den`` (every quotient bit comes out 1), which is
    what the reference's bit-serial loop returns. Computed in closed form in
    int64 — ``min((num << P) // den, 2^P - 1)`` — rather than P serial
    steps."""
    q = (num.to(torch.int64) << frac_bits) // den.to(torch.int64)
    return torch.clamp_max(q, 2**frac_bits - 1).to(torch.int32)


def int_exp_codes(v_stable, cfg: PrecisionConfig):
    """Integer exponential: codes v_stable (<=0, scale S) -> v_approx (scale aS^2).

    Alg. 1 lines 5-11 with a single Barrett correction step so the remainder
    lands exactly in (-v_ln2, 0] (the polynomial's domain)."""
    v_stable = v_stable.to(torch.int32)
    neg = -v_stable  # in [0, 2^(M-1)]
    # Barrett quotient: q_hat = floor(neg * mu / 2^(2M)), q_hat in {q, q-1}.
    q = (neg * cfg.mu) >> (2 * cfg.M)
    r = v_stable + q * cfg.v_ln2
    # correction: pull r into (-v_ln2, 0]
    need = r <= -cfg.v_ln2
    q = torch.where(need, q + 1, q)
    r = torch.where(need, r + cfg.v_ln2, r)
    # v_corr column width clamp (Table I; inactive for all paper configs)
    r = torch.clamp_min(r, -(2 ** (cfg.w_vcorr - 1)))
    t = r + cfg.v_b
    poly = _sat(t * t + cfg.v_c, cfg.w_poly)
    # poly << (F - q), a right shift once q > F. Both shift amounts are
    # clamped to <= 31: a shift by 32 or more is undefined in int32.
    sh = cfg.exp_shift - torch.clamp_max(q, 31 + cfg.exp_shift)
    v_approx = torch.where(sh >= 0,
                           poly << torch.clamp_min(sh, 0),
                           poly >> torch.clamp_max(-sh, 31))
    return _sat(v_approx, cfg.w_vapprox)


def int_softmax_from_codes(v, cfg: PrecisionConfig, mask=None, axis: int = -1,
                           assume_stable: bool = False, div: str = "auto"):
    """Alg. 1 on integer codes ``v`` (scale S). Returns fixed-point
    probability codes with ``cfg.P_out`` fractional bits (scale 2^-P_out).

    ``assume_stable``: codes are already max-subtracted (<= 0), as produced
    by ``quantize_stable_scores``; the integer max-subtract still runs.
    ``div``: "auto" or "bitserial" — see the module docstring for where the
    two differ."""
    if div not in ("auto", "bitserial"):
        raise ValueError(f"div must be 'auto' or 'bitserial', got {div!r}")
    v = v.to(torch.int32)
    if mask is not None:
        v = torch.where(mask, v, -(2 ** (cfg.M - 1)))
    # l.4 integer max-subtract (numerical stability)
    v_stable = v - torch.amax(v, dim=axis, keepdim=True)
    if not assume_stable:
        v_stable = torch.clamp(v_stable, -(2 ** (cfg.M - 1)), 0)
    v_approx = int_exp_codes(v_stable, cfg)
    if mask is not None:
        v_approx = torch.where(mask, v_approx, 0)
    total = saturating_sum(v_approx, cfg.sum_saturation, axis=axis)
    total = torch.clamp_min(total, 1).unsqueeze(axis)
    # l.12 fixed-point division into the R column (P_out = 2M+12 bits)
    if div == "auto" and cfg.w_vapprox + cfg.P_out <= 31:
        return (v_approx << cfg.P_out) // total  # fast path: 2^P at num == den
    return fixedpoint_div(v_approx, total, cfg.P_out)


def int_softmax_block(x, mask, cfg: PrecisionConfig):
    """Float scores -> float32 probabilities over the LAST axis, with the
    bit-serial division: the body every Alg.-1 kernel computes."""
    v = quantize_stable_scores(x, cfg, mask=mask, axis=-1)
    codes = int_softmax_from_codes(v, cfg, mask=mask, axis=-1,
                                   assume_stable=True, div="bitserial")
    return dequantize_probs(codes, cfg)
