"""Softmax-variant zoo backends: ConSmax, SOLE, MIVE as serving backends
(port of ``src/repro/backends/variant_backends.py``, same kind strings).

Each variant pairs its math from ``core.softmax_variants`` with its Table-II
cost schedule from ``ap.cost_model`` (``variant_vector_cost`` and the
``*_row_bits``), so ``SlotCostAttributor`` / EDP telemetry meters them as it
meters the Alg.-1 family: the same vectors/heads accounting, another
per-vector schedule. Registered kinds are valid ``SoftmaxSpec`` and
``ServeOptions.softmax_kind`` values.

* ``consmax`` — learnable beta/gamma, no reduction and no division; cycles
  per vector independent of the sequence length.
* ``sole`` — two-stage low-precision base-2 softmax; keeps the reduction,
  replaces the divider with a log-domain reciprocal.
* ``mive`` — minimal shift-add integer-vector lowering; the cheapest
  schedule, the coarsest grid (every weight a power of two).

None of them is the Alg.-1 dataflow, so the fused paged kernels (Alg. 1
only) reject them: ``Engine.serve`` with ``kernel="pallas"`` raises.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.ap import cost_model as cm
from repro_torch.backends.registry import register_backend
from repro_torch.backends.torch_backends import IntBackendBase
from repro_torch.core.precision import BEST, PrecisionConfig
from repro_torch.core.softmax_variants import (
    CONSMAX_DEFAULT,
    ConSmaxCfg,
    consmax,
    mive_softmax,
    sole_softmax,
)


@register_backend("consmax")
class ConSmaxBackend(IntBackendBase):
    """ConSmax (arxiv 2402.10930): gamma * exp(x - beta), learnable params.

    ``apply`` takes an optional ``params`` dict ({"beta", "gamma"} tensors
    broadcastable to the scores): the learned per-head values a model built
    with ``softmax.kind == "consmax"`` carries in ``p["smx"]``; without it
    the cfg's scalar defaults apply. The forward is the integer exp (STE
    backward), so serve == eager bit-exactly."""

    name = "consmax"
    default_cfg = CONSMAX_DEFAULT
    learnable = True  # attention passes p["smx"] through apply(params=...)

    def __init__(self, cfg: Optional[ConSmaxCfg] = None):
        if cfg is None:
            cfg = CONSMAX_DEFAULT
        elif isinstance(cfg, PrecisionConfig):
            # SoftmaxSpec resolves backends with its PrecisionConfig: wrap it
            # at the default beta/gamma operating point
            cfg = ConSmaxCfg(precision=cfg)
        super().__init__(cfg)

    def apply(self, scores, mask=None, axis: int = -1, params=None):
        beta = None if params is None else params.get("beta")
        gamma = None if params is None else params.get("gamma")
        return consmax(scores, cfg=self.cfg, mask=mask, axis=axis,
                       beta=beta, gamma=gamma)

    def _vector_cost(self, seq_len: int):
        return cm.variant_vector_cost("consmax", self.cfg.precision, seq_len)

    def design(self, seq_len: int) -> cm.APDesign:
        return cm.APDesign(rows=max(seq_len // 2, 1),
                           row_bits=cm.consmax_row_bits(self.cfg.precision))


class _PrecisionVariantBase(IntBackendBase):
    """Shared shell of the PrecisionConfig-keyed variants (sole, mive)."""

    kind: str = "?"

    def __init__(self, cfg: Optional[PrecisionConfig] = None):
        super().__init__(cfg or BEST)

    def _vector_cost(self, seq_len: int):
        return cm.variant_vector_cost(self.kind, self.cfg, seq_len)

    def design(self, seq_len: int) -> cm.APDesign:
        _, _, _, design = cm.variant_vector_cost(self.kind, self.cfg, seq_len)
        return design


@register_backend("sole")
class SoleBackend(_PrecisionVariantBase):
    """SOLE-style two-stage low-precision softmax (shift-add exp, log-domain
    reciprocal)."""

    name = "sole"
    kind = "sole"

    def apply(self, scores, mask=None, axis: int = -1):
        return sole_softmax(scores, cfg=self.cfg, mask=mask, axis=axis)


@register_backend("mive")
class MiveBackend(_PrecisionVariantBase):
    """MIVE-style minimal shift-add integer-vector softmax lowering."""

    name = "mive"
    kind = "mive"

    def apply(self, scores, mask=None, axis: int = -1):
        return mive_softmax(scores, cfg=self.cfg, mask=mask, axis=axis)
