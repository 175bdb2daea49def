"""Softmax dispatcher: the pluggable point where SoftmAP enters the models
(port of the dispatcher half of ``src/repro/core/softmax_variants.py``).

``SoftmaxSpec`` names an execution backend from the port's registry
(``repro_torch.backends``) plus its precision point, with the reference's
kind strings: ``"fp"`` is the baseline, ``"int"``/``"int_jax"`` the plain
torch Alg. 1, ``"int_pallas"`` the hand-written CUDA kernel (the kind keeps
the reference's name). The variant zoo's math (consmax, sole, mive) is not
ported yet (ROADMAP.md, Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def spec_backend(spec: Optional[SoftmaxSpec]) -> SoftmaxBackend:
    """Resolve a (possibly None) spec to its backend instance."""
    return (spec or SoftmaxSpec()).backend()


def get_softmax(spec: Optional[SoftmaxSpec]):
    return spec_backend(spec).apply
