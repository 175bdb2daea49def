"""Straggler detection and mitigation policy for long-running jobs (a copy
of ``src/repro/distributed/straggler.py``: host-side and framework-agnostic).
On one card the launcher passes no ``remesh_fn``, so a "remesh"
recommendation checkpoints and reports the request, as the reference does
without one; re-meshing a running job is ROADMAP.md Queue 1 item 23
(``distributed/elastic.py`` plans the mesh).

At 1000+ nodes the common failure mode is not a crash but a *slow* chip/host
(thermal throttle, failing HBM, noisy neighbor on DCN). Because every step is
a global barrier (the gradient all-reduce), one straggler sets the fleet's
pace. The monitor watches per-step wall times on the host, classifies
anomalies against a rolling median, and escalates:

  level 0  healthy          — nothing
  level 1  transient spike  — log it (data loader hiccup, GC)
  level 2  sustained slow   — recommend checkpoint-now (cheap insurance)
  level 3  chronic          — recommend re-mesh: checkpoint, drop the slow
                              host's rows via elastic.plan_mesh, restore

The policy is deliberately host-side and framework-agnostic: the train loop
calls ``observe(step_time)`` and acts on the returned recommendation; the
actual moves reuse the checkpoint manager + elastic re-mesh that already
exist (the whole mitigation is ~5 lines in the launcher).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional


@dataclasses.dataclass
class Recommendation:
    level: int                 # 0..3
    action: str                # "none" | "log" | "checkpoint" | "remesh"
    reason: str
    slowdown: float            # step_time / rolling median


class StragglerMonitor:
    def __init__(self, window: int = 50, spike_factor: float = 2.0,
                 sustain_factor: float = 1.3, sustain_steps: int = 10,
                 chronic_steps: int = 50, warmup: int = 5):
        self.window = window
        self.spike_factor = spike_factor
        self.sustain_factor = sustain_factor
        self.sustain_steps = sustain_steps
        self.chronic_steps = chronic_steps
        self.warmup = warmup
        self._times: Deque[float] = deque(maxlen=window)
        self._slow_streak = 0
        self._seen = 0

    def median(self) -> Optional[float]:
        if not self._times:
            return None
        s = sorted(self._times)
        return s[len(s) // 2]

    def observe(self, step_time: float) -> Recommendation:
        self._seen += 1
        med = self.median()
        # warm up the baseline before judging (compile steps are slow)
        if med is None or self._seen <= self.warmup:
            self._times.append(step_time)
            return Recommendation(0, "none", "warmup", 1.0)
        slowdown = step_time / med
        if slowdown < self.sustain_factor:
            self._slow_streak = 0
            self._times.append(step_time)
            return Recommendation(0, "none", "healthy", slowdown)
        self._slow_streak += 1
        # sustained-slow steps are NOT folded into the baseline (they would
        # normalize the regression away)
        if self._slow_streak >= self.chronic_steps:
            return Recommendation(
                3, "remesh",
                f"{self._slow_streak} consecutive steps >= "
                f"{self.sustain_factor:.1f}x median — chronic straggler; "
                "checkpoint and re-mesh without the slow host", slowdown)
        if self._slow_streak >= self.sustain_steps:
            return Recommendation(
                2, "checkpoint",
                f"{self._slow_streak} consecutive slow steps — take a "
                "checkpoint now in case this becomes a failure", slowdown)
        if slowdown >= self.spike_factor:
            return Recommendation(
                1, "log", f"step {slowdown:.1f}x median (transient spike)",
                slowdown)
        return Recommendation(1, "log", "mildly slow", slowdown)


def mitigate(rec: Recommendation, mgr, state, step: int,
             remesh_fn=None) -> Optional[str]:
    """The launcher-side glue: act on a recommendation using the existing
    checkpoint manager (+ optional re-mesh callback). Returns what was done."""
    if rec.action == "checkpoint" and mgr is not None:
        mgr.maybe_save(step, state, force=True)
        return f"checkpointed at step {step} ({rec.reason})"
    if rec.action == "remesh":
        if mgr is not None:
            mgr.maybe_save(step, state, force=True)
        if remesh_fn is not None:
            remesh_fn()
            return f"checkpoint + re-mesh triggered ({rec.reason})"
        return f"checkpointed; re-mesh requested ({rec.reason})"
    return None
