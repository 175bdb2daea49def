"""``int_pallas_paged``: the integer softmax riding the fused paged-decode
kernel (port of ``src/repro/backends/paged_kernel.py``; the kind keeps the
reference's name).

``apply`` computes Alg. 1 as ``int_pallas`` does: K1 on a CUDA tensor, the
plain version on a CPU or meta tensor. K1 is bitwise equal to the plain
Alg. 1 the reference's ``apply`` runs, so prefill and every non-paged site
give the same values under either name. What the name changes is paged
decode: ``models/attention.py`` and ``models/mla.py`` probe
``fused_paged_decode`` and run K2 or K4 (``kernels/paged_attention``)
instead of gather-then-attend. The meter is
the shared Table-II meter, so CostReports compare across substrates.
"""

from __future__ import annotations

from repro_torch.backends.registry import register_backend
from repro_torch.backends.torch_backends import IntPallasBackend

#: the softmax kinds that run Alg. 1, so that ``int_pallas_paged`` (and its
#: fused paged kernels) computes the same thing at their paged decode sites
ALG1_KINDS = ("int", "int_jax", "int_pallas", "int_pallas_paged")


@register_backend("int_pallas_paged")
class IntPallasPagedBackend(IntPallasBackend):
    """Integer softmax whose paged-decode sites run the fused block-table
    kernels K2 (GQA) and K4 (MLA): no dense gather."""

    name = "int_pallas_paged"
    fused_paged_decode = True
