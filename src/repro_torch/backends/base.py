"""Softmax execution-backend contract: one algorithm, many substrates.

A copy of the reference contract (``src/repro/backends/base.py``). A
:class:`SoftmaxBackend` is one way of executing SoftmAP's softmax — plain
torch Alg. 1, the hand-written CUDA kernel, or a floating-point baseline. All
of them share the contract

    apply(scores, mask=None, axis=-1) -> probabilities
    meter(shape, axis=-1, heads=1)    -> CostReport | None

``apply`` runs inside model forward passes; ``meter`` is pure Python over
tensor *shapes*, so the cost telemetry rides along with a meta-device forward
pass that computes nothing (see ``repro_torch.backends.telemetry``).
Backends with no hardware cost model (the fp family) return ``None`` from
``meter``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Aggregate AP cost of a set of softmax executions (Table-II model).

    ``cycles``/``latency_s`` are the critical path: vectors mapped to the same
    AP run sequentially, distinct head-APs run in parallel (the paper deploys
    one AP per attention head). ``energy_j`` sums over every AP. Reports
    compose with ``+`` (sequential program phases) and ``scaled`` (a phase
    repeated k times, e.g. one decode step x k generated tokens).
    """

    backend: str = ""
    vectors: int = 0          # softmax rows executed
    cycles: int = 0           # AP cycles on the critical path
    latency_s: float = 0.0
    energy_j: float = 0.0

    @property
    def edp(self) -> float:
        """Energy-delay product (the paper's Fig.-8 metric)."""
        return self.energy_j * self.latency_s

    def scaled(self, k: int) -> "CostReport":
        return dataclasses.replace(
            self, vectors=self.vectors * k, cycles=self.cycles * k,
            latency_s=self.latency_s * k, energy_j=self.energy_j * k)

    def scaled_f(self, k: float) -> "CostReport":
        """Fractional scaling, for attributing a batch-wide report across the
        requests that shared it (continuous-batching serving): ``vectors`` /
        ``cycles`` become floats in the result. Shares of a report composed
        back with ``+`` reproduce the original up to float rounding."""
        return self.scaled(k)

    def __add__(self, other: "CostReport") -> "CostReport":
        if not isinstance(other, CostReport):
            return NotImplemented
        name = self.backend if self.backend == other.backend else (
            self.backend or other.backend if not (self.backend and other.backend)
            else "mixed")
        return CostReport(
            backend=name,
            vectors=self.vectors + other.vectors,
            cycles=self.cycles + other.cycles,
            latency_s=self.latency_s + other.latency_s,
            energy_j=self.energy_j + other.energy_j)

    def describe(self) -> str:
        return (f"CostReport(backend={self.backend!r}, vectors={self.vectors}, "
                f"cycles={self.cycles}, latency={self.latency_s:.3e}s, "
                f"energy={self.energy_j:.3e}J, edp={self.edp:.3e})")


ZERO_COST = CostReport()


class SoftmaxBackend:
    """Base class for softmax execution backends.

    Subclasses set ``name`` (the primary registry key), implement ``apply``,
    and — if a hardware cost model exists for the substrate — override
    ``meter`` and set ``metered = True``.
    """

    name: str = "?"
    metered: bool = False  # True when meter() yields a real hardware cost
    # False for substrates apply() cannot differentiate through (the CUDA
    # kernel); training paths must then swap in a differentiable spec
    differentiable: bool = True
    # canonical config substituted for cfg=None by the registry, so
    # get_backend(name) and get_backend(name, <default>) share one instance
    default_cfg = None

    def __init__(self, cfg=None):
        self.cfg = cfg

    def apply(self, scores, mask=None, axis: int = -1):
        """scores (any leading dims) -> probabilities over ``axis``."""
        raise NotImplementedError

    def meter(self, shape: Sequence[int], axis: int = -1,
              heads: int = 1) -> Optional[CostReport]:
        """AP cost of softmaxing a tensor of ``shape`` (static ints), with
        ``heads`` parallel APs sharing the work. None when unmetered."""
        return None

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} cfg={self.cfg!r}>"
