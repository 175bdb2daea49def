"""Built-in torch softmax backends: fp baselines + the integer family (port
of ``src/repro/backends/jax_backends.py``, same kind strings and ``name``
attributes, so ``CostReport.backend`` reads as in the reference).

The integer backends share one meter — the Table-II AP cost model — because
they all execute the same Alg.-1 body; what differs is the substrate
``apply`` runs on (plain torch, STE-wrapped torch, the CUDA kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.ap import cost_model as cm
from repro_torch.backends.base import CostReport, SoftmaxBackend
from repro_torch.backends.registry import register_backend
from repro_torch.core.int_softmax import (
    clipped_fp_softmax,
    fp_softmax,
    fp_softmax_lowp,
    int_softmax,
    int_softmax_ste,
)
from repro_torch.core.precision import BEST, PrecisionConfig


# ----------------------------------------------------------- fp family (unmetered)


@register_backend("fp")
class FPBackend(SoftmaxBackend):
    """Floating-point reference softmax."""

    name = "fp"

    def apply(self, scores, mask=None, axis: int = -1):
        return fp_softmax(scores, mask=mask, axis=axis)


@register_backend("fp_lowp")
class FPLowPBackend(SoftmaxBackend):
    """Low-precision fp softmax (elementwise in input dtype, f32 sum)."""

    name = "fp_lowp"

    def apply(self, scores, mask=None, axis: int = -1):
        return fp_softmax_lowp(scores, mask=mask, axis=axis)


@register_backend("clipped_fp")
class ClippedFPBackend(SoftmaxBackend):
    """FP softmax with SoftmAP's input clipping only (ablation)."""

    name = "clipped_fp"
    default_cfg = BEST

    def __init__(self, cfg: Optional[PrecisionConfig] = None):
        super().__init__(cfg or BEST)

    def apply(self, scores, mask=None, axis: int = -1):
        return clipped_fp_softmax(scores, t_c=self.cfg.T_C, mask=mask, axis=axis)


# ------------------------------------------------- integer family (AP-metered)


class IntBackendBase(SoftmaxBackend):
    """Shared Table-II meter for every integer-path backend."""

    metered = True
    default_cfg = BEST

    def __init__(self, cfg: Optional[PrecisionConfig] = None):
        super().__init__(cfg or BEST)

    def meter(self, shape: Sequence[int], axis: int = -1,
              heads: int = 1) -> Optional[CostReport]:
        shape = tuple(int(d) for d in shape)
        if not shape:
            return None
        seq_len = shape[axis]
        vectors = 1
        for d in shape:
            vectors *= d
        vectors //= max(seq_len, 1)
        if vectors == 0 or seq_len == 0:
            return CostReport(backend=self.name)
        cycles_v, lat_v, e_v, _ = cm.softmax_vector_cost(self.cfg, seq_len)
        # One AP per head (Sec. V-B): a head-AP runs its vectors sequentially
        # (word-parallel inside each vector); distinct heads run in parallel.
        per_ap = -(-vectors // max(int(heads), 1))  # ceil
        return CostReport(backend=self.name, vectors=vectors,
                          cycles=cycles_v * per_ap, latency_s=lat_v * per_ap,
                          energy_j=e_v * vectors)


@register_backend("int", "int_jax")
class IntJaxBackend(IntBackendBase):
    """Alg. 1 in plain torch (the paper's reference integer path). The name
    keeps the reference's ``int_jax``."""

    name = "int_jax"

    def apply(self, scores, mask=None, axis: int = -1):
        return int_softmax(scores, cfg=self.cfg, mask=mask, axis=axis)


@register_backend("int_ste")
class IntSTEBackend(IntBackendBase):
    """Integer forward, fp-softmax backward (QAT straight-through)."""

    name = "int_ste"

    def apply(self, scores, mask=None, axis: int = -1):
        return int_softmax_ste(scores, cfg=self.cfg, mask=mask, axis=axis)


@register_backend("int_pallas")
class IntPallasBackend(IntBackendBase):
    """Alg. 1 through the hand-written CUDA kernel (K1) on CUDA tensors, its
    plain version on CPU tensors. The kind keeps the reference's name."""

    name = "int_pallas"
    differentiable = False  # the kernel has no backward

    def apply(self, scores, mask=None, axis: int = -1):
        from repro_torch.kernels.int_softmax.ops import int_softmax_cuda

        return int_softmax_cuda(scores, cfg=self.cfg, mask=mask, axis=axis)
