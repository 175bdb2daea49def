"""Softmax dispatcher and the softmax-variant zoo (port of
``src/repro/core/softmax_variants.py``).

``SoftmaxSpec`` names an execution backend from the port's registry
(``repro_torch.backends``) plus its precision point, with the reference's
kind strings: ``"fp"`` is the baseline, ``"int"``/``"int_jax"`` the plain
torch Alg. 1, ``"int_pallas"`` the hand-written CUDA kernel (the kind keeps
the reference's name), ``"ap_sim"`` the functional 2D-AP simulator, and the
zoo ``"consmax"``, ``"sole"``, ``"mive"``.

The zoo's math — attention-weight functions sharing Alg. 1's quantization
grid so they map to the same 2D-AP column layout (cost models in
``repro_torch.ap.cost_model``):

* :func:`consmax` — ConSmax (arxiv 2402.10930): ``gamma * exp(x - beta)``
  with learnable per-head ``beta``/``gamma`` in place of the max-subtraction
  and the sum/division. No cross-row reduction at all.
* :func:`sole_softmax` — SOLE-style two-stage low-precision softmax:
  linear-fraction base-2 exp, then a log-domain reciprocal.
* :func:`mive_softmax` — MIVE-style minimal integer-vector lowering: every
  weight a power of two, normalization one shift-add reciprocal.

Every division by a precision constant is a true IEEE division by a 0-dim
tensor made by a fill on the data's device (as ``core/quantization.py``
does for ``quantize_stable_scores``): PyTorch's CUDA division by a Python
scalar multiplies by the reciprocal, which can move a code by one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.backends.base import SoftmaxBackend
from repro_torch.backends.registry import get_backend, settled_backend_names
from repro_torch.core.precision import BEST, PrecisionConfig


@dataclasses.dataclass(frozen=True)
class SoftmaxSpec:
    kind: str = "fp"  # any key in repro_torch.backends.available_backends()
    precision: PrecisionConfig = BEST

    def __post_init__(self):
        # Eager validation whenever the registry is settled; None only while
        # the backend modules are mid-import, where an unknown kind still
        # fails at backend() resolution.
        names = settled_backend_names()
        if names is not None and self.kind not in names:
            raise ValueError(
                f"unknown softmax kind: {self.kind!r}; registered backends: "
                f"{', '.join(names)}")

    def backend(self) -> SoftmaxBackend:
        return get_backend(self.kind, self.precision)

    def fn(self):
        """apply-callable, kept for call sites that only need the function."""
        return self.backend().apply


def spec_backend(spec: Optional[SoftmaxSpec]) -> SoftmaxBackend:
    """Resolve a (possibly None) spec to its backend instance."""
    return (spec or SoftmaxSpec()).backend()


def get_softmax(spec: Optional[SoftmaxSpec]):
    return spec_backend(spec).apply


FP = SoftmaxSpec("fp")
INT_BEST = SoftmaxSpec("int", BEST)


# --------------------------------------------------------------- variant math

LOG2E = 1.0 / math.log(2.0)


@dataclasses.dataclass(frozen=True)
class ConSmaxCfg:
    """ConSmax operating point: default beta/gamma (used when a model carries
    no learned ``smx`` params) and the Alg.-1 precision grid its integer exp
    runs on. Frozen and hashable, so the backend registry can cache on it."""

    beta: float = 0.0
    gamma: float = 1.0
    precision: PrecisionConfig = BEST


CONSMAX_DEFAULT = ConSmaxCfg()


def _scalar(value, like):
    """A 0-dim f32 tensor holding ``value``, made by a fill on ``like``'s
    device (capturable in a CUDA graph)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def consmax_codes(x, cfg: ConSmaxCfg = CONSMAX_DEFAULT, beta=None):
    """ConSmax's integer exp codes (int32, scale ``exp_scale``): the scores
    less beta, clipped to [T_C, 0], quantized to M-bit codes and through
    Alg. 1's integer exp — the forward values :func:`consmax` scales by
    gamma."""
    from repro_torch.core.alg1 import int_exp_codes

    pc = cfg.precision
    x = x.to(torch.float32)
    b = _scalar(cfg.beta, x) if beta is None else beta.to(torch.float32)
    xs = torch.clamp(x - b, pc.T_C, 0.0)
    v = torch.round(xs / _scalar(pc.S, x)).to(torch.int32)
    return int_exp_codes(v, pc)


def consmax(x, cfg: ConSmaxCfg = CONSMAX_DEFAULT, mask=None, axis: int = -1,
            beta=None, gamma=None):
    """ConSmax attention weights: ``gamma * exp(clip(x - beta, T_C, 0))``.

    ``beta`` stands in for the row max and ``gamma`` for the reciprocal sum:
    no cross-row reduction and no division. The forward exp is Alg. 1's
    integer exp (M-bit codes -> I-BERT polynomial, ``alg1.int_exp_codes``);
    the smooth fp exp is the backward (a straight-through estimator, the
    reference's expression ``g * (y_fp + (y_int - y_fp).detach())``), so
    beta, gamma and the scores get gradients. ``beta``/``gamma``: tensors
    broadcastable to the scores (learned per-head values) or None for the
    cfg's scalars. ``axis`` is accepted for the backend contract; the map is
    elementwise."""
    pc = cfg.precision
    x = x.to(torch.float32)
    b = _scalar(cfg.beta, x) if beta is None else beta.to(torch.float32)
    g = _scalar(cfg.gamma, x) if gamma is None else gamma.to(torch.float32)
    y_fp = torch.exp(torch.clamp(x - b, pc.T_C, 0.0))
    y_int = consmax_codes(x.detach(), cfg, b.detach()).to(torch.float32) * pc.exp_scale
    y = g * (y_fp + (y_int - y_fp).detach())
    if mask is not None:
        y = torch.where(mask, y, 0.0)
    return y


def sole_softmax(x, cfg: PrecisionConfig = BEST, mask=None, axis: int = -1):
    """SOLE-style two-stage low-precision softmax.

    Stage 1 (per element, shift-add only): ``t = (x - max) * log2(e)`` splits
    into integer and fraction; ``2^t ~= (1 + frac) << int`` (piecewise-linear
    base-2 exp), rounded to the ``w_vapprox``-fractional-bit grid. Stage 2
    (per vector): the sum is inverted in the log domain — leading-one
    detection gives ``floor(log2 s)``, the residue's linear fraction
    completes ``log2 s``, and the reciprocal is the same linear base-2 exp of
    its negation. Table-II schedule: ``ap.cost_model.sole_cycle_breakdown``."""
    x = x.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, -1e30)
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    t = (x - m) * LOG2E
    ti = torch.floor(t)
    e = (1.0 + (t - ti)) * torch.exp2(ti)
    grid = 2.0 ** cfg.w_vapprox
    e = torch.round(e * grid) / grid        # a power of two: exact either way
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    s = torch.clamp_min(torch.sum(e, dim=axis, keepdim=True), 1.0 / grid)
    ls = torch.floor(torch.log2(s))
    ls = ls + (s * torch.exp2(-ls) - 1.0)          # linear log2 fraction
    li = torch.floor(-ls)
    recip = (1.0 + (-ls - li)) * torch.exp2(li)    # linear base-2 exp again
    return e * recip


def mive_softmax(x, cfg: PrecisionConfig = BEST, mask=None, axis: int = -1):
    """MIVE-style minimal integer-vector shift-add softmax.

    Exponents round to integers, so every weight is a power of two (the exp
    is a shift of a unit code); exponents below the ``w_vapprox`` column
    width underflow to zero. Normalization is one shift-add reciprocal:
    ``1/s ~= (1.5 - s_frac/2) * 2^-floor(log2 s)``. No multiplier anywhere:
    the cheapest point of the zoo, and the coarsest. Table-II schedule:
    ``ap.cost_model.mive_cycle_breakdown``."""
    x = x.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, -1e30)
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    t = torch.round((x - m) * LOG2E)
    w_acc = float(cfg.w_vapprox)
    e = torch.where(t >= -w_acc, torch.exp2(torch.clamp_min(t, -w_acc)), 0.0)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    s = torch.clamp_min(torch.sum(e, dim=axis, keepdim=True), 2.0 ** -w_acc)
    si = torch.floor(torch.log2(s))
    recip = (1.5 - 0.5 * s * torch.exp2(-si)) * torch.exp2(-si)
    return e * recip
