"""AP cost telemetry: CostReport accumulation across a model forward pass.

A copy of the reference module (``src/repro/backends/telemetry.py``) plus
:func:`scan_range`. Every cost quantity depends only on tensor shapes, so one
forward pass on the ``meta`` device (no storage, no compute) visits every
softmax call site with its real shapes. ``models/attention.py`` calls
:func:`record_softmax` at each site; this module routes the metered
:class:`CostReport` into whichever accumulators are active on the current
thread.

The reference traces a ``lax.scan`` body ONCE for n iterations and wraps it in
:func:`repeat`, so it records ``report.scaled(n)``. The port's Python loops
run every iteration; they iterate with :func:`scan_range`, which meters the
first iteration ``n`` times over and mutes the rest. Wrapping the loops in
``repeat`` instead would count n^2, and recording every iteration would sum n
floats where the reference multiplies once — the reports would then differ in
the last bits.

Usage (what ``serving.engine.Engine.meter_request`` does):

    with telemetry.collect() as acc:
        model.prefill(meta_params, meta_batch, cache_len=L)
    prefill_cost = acc.total()
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

from repro_torch.backends.base import ZERO_COST, CostReport, SoftmaxBackend

_TLS = threading.local()


def _accumulators() -> List["CostAccumulator"]:
    if not hasattr(_TLS, "accumulators"):
        _TLS.accumulators = []
    return _TLS.accumulators


def _multiplier() -> int:
    return getattr(_TLS, "multiplier", 1)


class CostAccumulator:
    """Collects CostReports recorded while it is active."""

    def __init__(self):
        self.reports: List[CostReport] = []

    def add(self, report: CostReport) -> None:
        self.reports.append(report)

    def total(self) -> CostReport:
        total = ZERO_COST
        for r in self.reports:
            total = total + r
        return total


@contextlib.contextmanager
def collect():
    """Activate a fresh accumulator on this thread; yields it."""
    acc = CostAccumulator()
    _accumulators().append(acc)
    try:
        yield acc
    finally:
        _accumulators().remove(acc)


@contextlib.contextmanager
def repeat(n: int):
    """Multiply any record() inside by ``n`` (trace-once/run-n scan bodies).
    Nested repeats compose multiplicatively."""
    old = _multiplier()
    _TLS.multiplier = old * max(int(n), 0)
    try:
        yield
    finally:
        _TLS.multiplier = old


def scan_range(n: int):
    """``range(n)`` for a Python loop that stands in for a reference
    ``lax.scan``: iteration 0 runs under ``repeat(n)``, the others under
    ``repeat(0)`` (muted), so the loop records exactly what the reference's
    trace-once scan records. Every iteration must meter the same shapes."""
    for i in range(n):
        with repeat(n if i == 0 else 0):
            yield i


def active() -> bool:
    return bool(_accumulators())


def record(report: Optional[CostReport]) -> None:
    """Add a report (scaled by the ambient repeat multiplier) to every active
    accumulator. No-op when nothing is collecting, the report is None, or
    the multiplier is 0 (a muted :func:`scan_range` iteration)."""
    accs = _accumulators()
    if not accs or report is None or _multiplier() == 0:
        return
    report = report.scaled(_multiplier())
    for acc in accs:
        acc.add(report)


def record_softmax(backend: SoftmaxBackend, shape: Sequence[int],
                   axis: int = -1, heads: int = 1) -> None:
    """Meter one softmax call site. Cheap no-op when nothing is collecting —
    safe to leave in hot trace paths."""
    if not _accumulators():
        return
    record(backend.meter(tuple(int(d) for d in shape), axis=axis, heads=heads))


class SlotCostAttributor:
    """Per-request attribution of batch-wide serving cost.

    The continuous-batching decode step is metered ONCE for the whole slot
    batch (its cost depends only on static shapes); each executed step then
    charges that report evenly to the requests active in it via
    :meth:`record_step`. Request-local costs (its own prefill trace) go in
    through :meth:`record_request`. The invariant the scheduler's property
    tests pin: the per-request reports sum to the batch meter —
    ``sum(attr.report_for(r) for r in rids) == batch_total`` up to float
    rounding, because every step's report is split with exact fractions
    ``1/len(active)``.

    Phase accounting: every record carries a ``kind`` ("decode" by default;
    the speculative serving loop charges "draft" and "verify" phases, the
    prefill path "prefill"), so draft and verify work show up separately in
    :meth:`total_kind` while still flowing through the one batch meter —
    the conservation invariant is per-kind-blind by construction.
    """

    def __init__(self):
        self._by_request: dict = {}
        self._batch_total = ZERO_COST
        self._by_kind: dict = {}
        self._savings: dict = {}
        self._shared_tokens: dict = {}

    def record_step(self, step_report: CostReport, active_requests,
                    kind: str = "decode") -> None:
        """Charge one executed decode step to the requests that rode in it."""
        active = list(active_requests)
        if not active:
            return
        self._batch_total = self._batch_total + step_report
        self._by_kind[kind] = self._by_kind.get(kind, ZERO_COST) + step_report
        share = step_report.scaled_f(1.0 / len(active))
        for rid in active:
            self._by_request[rid] = self._by_request.get(rid, ZERO_COST) + share

    def record_request(self, rid, report: CostReport,
                       kind: str = "prefill") -> None:
        """Charge a request-local phase (e.g. its prefill) to one request."""
        self._batch_total = self._batch_total + report
        self._by_kind[kind] = self._by_kind.get(kind, ZERO_COST) + report
        self._by_request[rid] = self._by_request.get(rid, ZERO_COST) + report

    def total_kind(self, kind: str) -> CostReport:
        """Everything charged under one phase kind; the kinds partition the
        batch meter: ``sum(total_kind(k) for k in kinds()) == total()``."""
        return self._by_kind.get(kind, ZERO_COST)

    def kinds(self):
        return sorted(self._by_kind)

    def record_shared_prefill(self, rid, executed: CostReport,
                              saved: CostReport, shared_tokens: int) -> None:
        """Charge a prefix-shared admission for the tail prefill it actually
        executed, and track the amortized prefix cost separately.

        ``executed`` is the metered tail-only prefill; ``saved`` is what the
        shared prefix would have cost to prefill standalone (the work the
        block reuse skipped). Only ``executed`` enters the batch meter —
        nobody ran the saved trace — so the conservation invariant
        (per-request shares sum to the batch total) is untouched; the
        savings are reported on the side via :meth:`savings_for`."""
        self.record_request(rid, executed)
        self._savings[rid] = self._savings.get(rid, ZERO_COST) + saved
        self._shared_tokens[rid] = (self._shared_tokens.get(rid, 0)
                                    + int(shared_tokens))

    def savings_for(self, rid) -> CostReport:
        """AP cost the request avoided by reusing shared prefix blocks."""
        return self._savings.get(rid, ZERO_COST)

    def total_savings(self) -> CostReport:
        total = ZERO_COST
        for r in self._savings.values():
            total = total + r
        return total

    def shared_tokens_for(self, rid) -> int:
        return self._shared_tokens.get(rid, 0)

    def report_for(self, rid) -> CostReport:
        return self._by_request.get(rid, ZERO_COST)

    def total(self) -> CostReport:
        """The batch meter: everything recorded, before attribution."""
        return self._batch_total

    def class_totals(self, class_of) -> dict:
        """Partition the attributed cost by tenant class.

        ``class_of`` maps a request id to its class label (e.g. the
        request's priority). Because per-request shares already sum to the
        batch meter, the returned per-class reports partition it too:
        ``sum(class_totals(f).values()) == total()`` up to float rounding —
        the multi-tenant fairness invariant the scheduler property suite
        pins."""
        out: dict = {}
        for rid, rep in self._by_request.items():
            c = class_of(rid)
            out[c] = out.get(c, ZERO_COST) + rep
        return out


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile without numpy (telemetry stays dependency-free
    of the serving layer)."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    idx = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[idx]


def class_latency_summary(results) -> dict:
    """Per-priority-class latency rollup over finished serve results.

    ``results`` is any sequence of objects with ``priority``, ``ttft_s``,
    ``tbt_s`` (list of inter-token gaps), ``deadline_met`` (Optional[bool])
    and ``preempts`` attributes — duck-typed so this module never imports
    the serving layer. Returns ``{priority: {n, ttft_p50, ttft_p99,
    tbt_p50, tbt_p99, sla_attainment, preemptions}}`` with latencies in
    seconds; ``sla_attainment`` is None when no request in the class
    carried a deadline."""
    by_class: dict = {}
    for r in results:
        by_class.setdefault(int(r.priority), []).append(r)
    out: dict = {}
    for cls, rs in sorted(by_class.items()):
        ttft = [r.ttft_s for r in rs]
        tbt = [g for r in rs for g in r.tbt_s]
        met = [r.deadline_met for r in rs if r.deadline_met is not None]
        out[cls] = {
            "n": len(rs),
            "ttft_p50": _percentile(ttft, 50), "ttft_p99": _percentile(ttft, 99),
            "tbt_p50": _percentile(tbt, 50), "tbt_p99": _percentile(tbt, 99),
            "sla_attainment": (sum(met) / len(met)) if met else None,
            "preemptions": sum(r.preempts for r in rs),
        }
    return out
