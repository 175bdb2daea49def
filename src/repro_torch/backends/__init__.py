"""Softmax execution backends of the port: one algorithm body, several
substrates, the reference's kind strings and AP cost meter.

``fp`` / ``fp_lowp`` / ``clipped_fp`` (floating-point baselines), ``int_jax``
(alias ``int``: plain torch Alg. 1), ``int_ste``, ``int_pallas`` (the
hand-written CUDA kernel K1), ``int_pallas_paged`` (K1, plus the fused
paged-decode kernel K2, or K4 for MLA, at paged decode sites), ``ap_sim``
(the functional 2D-AP simulator, a host round trip) and the variant zoo
``consmax`` / ``sole`` / ``mive``. Integer and variant backends also
*meter*: ``meter(shape)``
prices the work on the paper's AP via the Table-II cost model, and
``repro_torch.backends.telemetry`` accumulates those prices across a model
forward pass into :class:`CostReport`\\ s.
"""

from repro_torch.backends import telemetry  # noqa: F401
from repro_torch.backends.base import ZERO_COST, CostReport, SoftmaxBackend
from repro_torch.backends.registry import (
    available_backends,
    get_backend,
    register_backend,
)

__all__ = [
    "CostReport", "SoftmaxBackend", "ZERO_COST", "available_backends",
    "get_backend", "register_backend", "telemetry",
]
