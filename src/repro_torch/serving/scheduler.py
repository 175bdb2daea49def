"""Continuous-batching request scheduler: queue, slot allocator, admission,
and the KV block pool (a copy of ``src/repro/serving/scheduler.py``).

The module is pure Python and numpy, so the port copies it as it is: the
same requests, admission order, allocator state and traces as the reference
for the same inputs (``tests/test_torch_scheduler.py`` holds the two side by
side). The engine (``serving/engine.py``) owns the device side.

Admission policies:

  ``continuous``  admit the best waiting request whenever ANY slot is free —
                  the continuous-batching mode; mixed-length traffic wastes no
                  slot-steps.
  ``gang``        admit only when ALL slots are free, draining whole batches
                  — static batching as a degenerate trace of the same
                  executor.

Priority classes, aging, the head-of-line grace and preemption
(:meth:`SlotScheduler.preempt`, :class:`SwappedState`) are here too; the
port's engine drives the preemption half once chunked prefill and
preemption are ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request in a serving trace.

    ``arrival`` is in decode-step time units (the serve loop's clock): the
    request becomes visible to the scheduler at the first step whose time
    ``t >= arrival``. ``seed`` names the request's private PRNG stream —
    per-request eager generation with ``key=PRNGKey(seed)`` is the parity
    reference for its output.

    ``priority`` is the request's static class, 0 = most urgent (premium
    interactive), larger = batch/background. ``deadline`` is an OPTIONAL
    completion budget in clock units RELATIVE to arrival (finish by
    ``arrival + deadline``); it is SLA *reporting* metadata — per-class
    attainment in ``ServeReport.class_latency`` — not a scheduling input
    (EDF ordering is a noted follow-up).
    """

    rid: int
    prompt: np.ndarray            # [P] int32
    max_new: int
    arrival: float = 0.0
    seed: int = 0
    priority: int = 0
    deadline: Optional[float] = None
    # encoder-decoder only: precomputed encoder frames [enc_len, d_model]
    # (the stub frontend's output); every request in one serve call must
    # share a single frames shape — cross-attention is mask-free
    frames: Optional[np.ndarray] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])


@dataclasses.dataclass
class SlotState:
    """Bookkeeping for one occupied slot."""

    request: Request
    pos: int                      # next cache write position
    generated: List[int]          # tokens emitted so far (incl. first)
    done: bool = False            # EOS hit (emissions are pad from now on)
    admitted_at: float = 0.0
    # chunked prefill: the slot is reserved but its prompt is still being
    # committed in prefill_chunk-token pieces — NOT a decode lane yet
    prefilling: bool = False
    preempts: int = 0             # times this request was swapped out
    # speculative-decoding bookkeeping (zero when serving non-speculatively)
    drafted: int = 0              # draft tokens proposed for this slot
    accepted: int = 0             # draft tokens the verifier accepted
    draft_depth: int = 0          # depth of the most recent draft round


@dataclasses.dataclass
class SwappedState:
    """A preempted request: off-slot, off-device, waiting to resume.

    Everything the scheduler must restore exactly on re-admission so the
    resumed stream is bit-identical to an uninterrupted run: the generated
    tokens so far, the EOS flag, and the next cache write position. The
    ENGINE separately stashes the device payload (host copies of blocks it
    could not just release back to the allocator) keyed by rid."""

    request: Request
    generated: List[int]
    done: bool
    pos: int
    admitted_at: float            # first admission (for latency accounting)
    swapped_at: float
    preempts: int
    drafted: int = 0
    accepted: int = 0


class SlotScheduler:
    """FIFO queue + slot allocator over a fixed slot count.

    Driven by the engine loop as::

        sched.advance(t)                       # surface arrivals
        for slot, req in sched.admit(t): ...   # prefill + install
        ... run one decode step ...
        sched.release(slot)                    # on completion

    and by the property tests with a fake clock and no engine at all.
    """

    def __init__(self, requests: Sequence[Request], n_slots: int,
                 cache_len: int, policy: str = "continuous",
                 admit_ok: Optional[Callable[[Request], bool]] = None,
                 aging: float = 16.0, hol_grace: float = 32.0):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        if policy not in ("continuous", "gang"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if aging < 0 or hol_grace < 0:
            raise ValueError(f"aging/hol_grace must be >= 0, got "
                             f"({aging}, {hol_grace})")
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.policy = policy
        # resource gate (paged serving): admission additionally requires
        # admit_ok(request) — e.g. "enough free/evictable KV blocks for the
        # request's worst case". A deferred candidate no longer blocks the
        # queue outright (see admit()): smaller requests behind it may admit
        # until the deferral exceeds hol_grace, then admission turns strict
        # so blocks freed by completing requests reach the starved head.
        self._admit_ok = admit_ok
        # anti-starvation: effective class = priority - waited // aging.
        # aging=0 disables (pure strict classes — background traffic can
        # starve under sustained premium overload).
        self.aging = float(aging)
        self.hol_grace = float(hol_grace)
        for r in requests:
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            if r.prompt_len + r.max_new > cache_len:
                raise ValueError(
                    f"request {r.rid}: prompt_len {r.prompt_len} + max_new "
                    f"{r.max_new} exceeds cache_len {cache_len}")
        ids = [r.rid for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate request ids in trace")
        # submission index: the tie-break of last resort, so equal
        # (class, arrival) candidates admit in trace order
        self._submit_idx = {r.rid: i for i, r in enumerate(requests)}
        # stable sort: ties on arrival keep submission order (FIFO)
        self._pending = deque(sorted(requests, key=lambda r: r.arrival))
        self.queue: deque = deque()
        self.slots: List[Optional[SlotState]] = [None] * n_slots
        self._free: deque = deque(range(n_slots))
        self.admitted_order: List[int] = []   # rids, in admission order
        self.finished: Dict[int, SlotState] = {}
        # preempted requests waiting to swap back in, rid -> SwappedState
        self.swapped: "OrderedDict[int, SwappedState]" = OrderedDict()
        self.preemptions = 0
        self.resumes = 0

    # ------------------------------------------------------------- time flow

    def advance(self, t: float) -> None:
        """Move requests whose arrival time has come into the FIFO queue."""
        while self._pending and self._pending[0].arrival <= t:
            self.queue.append(self._pending.popleft())

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival if self._pending else None

    # ------------------------------------------------------------- admission

    def effective_class(self, req: Request, t: float) -> int:
        """Priority class after anti-starvation aging: drops by one for every
        ``aging`` clock units waited, so ANY request eventually outranks
        fresh arrivals of every static class (unbounded below)."""
        if self.aging <= 0:
            return req.priority
        return req.priority - int(max(0.0, t - req.arrival) // self.aging)

    def _admission_key(self, req: Request, t: float) -> tuple:
        # (aged class, static class, arrival, submission) — strict classes
        # first; within a class aging preserves arrival order (older waited
        # longer, so its effective class is never worse), giving exact FIFO
        return (self.effective_class(req, t), req.priority, req.arrival,
                self._submit_idx[req.rid])

    def _candidates(self, t: float) -> List[Request]:
        """Every waiting request — queued and swapped-out — in admission
        order. Swapped requests compete by their ORIGINAL arrival, so a
        preempted victim ages fast and swaps back in early."""
        cands = list(self.queue) + [sw.request for sw in self.swapped.values()]
        return sorted(cands, key=lambda r: self._admission_key(r, t))

    def admit(self, t: float = 0.0) -> Iterator[Tuple[int, Request]]:
        """Yield (slot, request) admissions under the active policy. The
        caller must install each admission (prefill + first token) and set
        the slot state via :meth:`install` before the next decode step; a
        resumed request (``request.rid in scheduler.swapped`` beforehand)
        comes back with its SlotState already carrying the generated stream
        and must NOT be re-installed — the engine restores device state.

        The caller MAY release a slot mid-iteration (a request whose budget
        is spent at admission, e.g. ``max_new == 1`` or first-token EOS).
        Under ``continuous`` the freed slot is immediately reusable; under
        ``gang`` the round is capped at ``n_slots`` admissions, so a
        mid-round release never lets a fresh request join the still-running
        batch — static batching stays static.

        Head-of-line behavior under the ``admit_ok`` resource gate: a
        deferred candidate is SKIPPED (later, smaller candidates may admit
        into free slots — the fix for chunked prefill, where a long prompt
        waiting for blocks used to stall every decode slot behind it) until
        it has waited ``hol_grace`` clock units; after that the round stops
        at it, so freed blocks accumulate for the starved head instead of
        being snatched forever by fresh small arrivals."""
        budget = None
        if self.policy == "gang":
            if any(s is not None for s in self.slots):
                return
            budget = self.n_slots
        for req in self._candidates(t):
            if not self._free or budget == 0:
                break
            if self._admit_ok is not None and not self._admit_ok(req):
                waited = t - req.arrival
                if waited >= self.hol_grace:
                    break                     # strict: conserve blocks for it
                continue                      # skip-ahead within grace
            if budget is not None:
                budget -= 1
            slot = self._free.popleft()
            sw = self.swapped.pop(req.rid, None)
            if sw is None:
                self.queue.remove(req)
                st = SlotState(request=req, pos=req.prompt_len,
                               generated=[], admitted_at=t)
            else:
                st = SlotState(request=req, pos=sw.pos,
                               generated=sw.generated, done=sw.done,
                               admitted_at=sw.admitted_at,
                               preempts=sw.preempts,
                               drafted=sw.drafted, accepted=sw.accepted)
                self.resumes += 1
            assert self.slots[slot] is None, "slot double-assignment"
            # reserve: installed by the caller, but mark occupied NOW so a
            # nested admit cannot hand the slot out twice
            self.slots[slot] = st
            self.admitted_order.append(req.rid)
            yield slot, req

    def install(self, slot: int, first_token: int, done: bool) -> None:
        """Record the admission-time first token (sampled from the prefill
        logits) for the reserved slot."""
        st = self.slots[slot]
        assert st is not None and not st.generated
        st.generated.append(int(first_token))
        st.done = bool(done)

    # ------------------------------------------------------------ slot state

    def release(self, slot: int) -> SlotState:
        st = self.slots[slot]
        assert st is not None, f"release of free slot {slot}"
        self.slots[slot] = None
        self._free.append(slot)
        self.finished[st.request.rid] = st
        return st

    def active_slots(self) -> List[int]:
        """Slots that decode this step — occupied AND fully installed. A
        slot whose prompt is still chunk-prefilling is occupied but not a
        decode lane yet (its row rides parked, writes dropped)."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilling]

    def active_requests(self) -> List[int]:
        return [s.request.rid for s in self.slots
                if s is not None and not s.prefilling]

    @property
    def unfinished(self) -> bool:
        return bool(self._pending or self.queue or self.swapped
                    or any(s is not None for s in self.slots))

    # ------------------------------------------------------------ preemption

    def preempt_victim(self, t: float) -> Optional[int]:
        """The slot to swap out for the best blocked waiter, or None.

        Preemption triggers only on STATIC class: the best waiting candidate
        must be blocked (no free slot, or ``admit_ok`` fails) and some
        installed slot must run a strictly worse static class. Aging never
        enables preemption (an aged background request outranks premium for
        ADMISSION order but cannot evict it) — strictness is what makes the
        preemption relation acyclic, so two classes can never thrash
        swapping each other. Victim choice: worst class first, then most
        recently admitted (it has the least sunk decode work). Slots still
        chunk-prefilling are never victims — nothing committed to resume."""
        cands = self._candidates(t)
        if not cands:
            return None
        cand = cands[0]
        blocked = not self._free or (
            self._admit_ok is not None and not self._admit_ok(cand))
        if not blocked:
            return None
        victims = [
            (s.request.priority, s.admitted_at, i)
            for i, s in enumerate(self.slots)
            if s is not None and not s.prefilling and s.generated
            and s.request.priority > cand.priority]
        if not victims:
            return None
        return max(victims)[2]

    def preempt(self, slot: int, t: float) -> SwappedState:
        """Swap a victim out: free its slot and park the request (with its
        generated stream, EOS flag, and cache position) in ``swapped``,
        where it competes for re-admission by its original arrival. The
        ENGINE owns the device side — releasing/copying blocks before this
        call and restoring them when :meth:`admit` yields the resume."""
        st = self.slots[slot]
        assert st is not None and st.generated and not st.prefilling, \
            f"preempting slot {slot} in state {st}"
        self.slots[slot] = None
        self._free.append(slot)
        sw = SwappedState(request=st.request, generated=st.generated,
                          done=st.done, pos=st.pos,
                          admitted_at=st.admitted_at, swapped_at=t,
                          preempts=st.preempts + 1,
                          drafted=st.drafted, accepted=st.accepted)
        self.swapped[st.request.rid] = sw
        self.preemptions += 1
        return sw

    def record_draft(self, slot: int, proposed: int, accepted: int) -> None:
        """Track one speculative round's per-slot draft depth and acceptance
        (``accepted <= proposed``); the aggregate acceptance rate is the
        serving telemetry that decides whether drafting pays off."""
        st = self.slots[slot]
        assert st is not None, f"draft record on free slot {slot}"
        assert 0 <= accepted <= proposed, (slot, proposed, accepted)
        st.drafted += int(proposed)
        st.accepted += int(accepted)
        st.draft_depth = int(proposed)

    def slot_done(self, slot: int) -> bool:
        """A slot is complete when its request's token budget is spent or its
        EOS flag is set (remaining emissions would all be pad)."""
        st = self.slots[slot]
        return st is not None and (
            len(st.generated) >= st.request.max_new or st.done)


# --------------------------------------------------------------- block pool


def prefix_keys(prompt: np.ndarray, block_size: int) -> List[bytes]:
    """Cumulative content keys of the prompt's FULL blocks.

    Key ``i`` identifies the cache content of block ``i`` — K/V entries at
    position ``j`` depend on tokens ``[0..j]`` (hidden states are causal), so
    the key must cover the whole prefix through block ``i``, not just that
    block's tokens. Exact prefix bytes are used instead of a hash: collision-
    free by construction, and at serving-trace scale the registry is tiny."""
    t = np.ascontiguousarray(np.asarray(prompt, np.int32))
    return [t[:(i + 1) * block_size].tobytes()
            for i in range(t.shape[-1] // block_size)]


class BlockAllocator:
    """Fixed pool of KV cache blocks: free list, refcounts, a prefix-content
    registry for cross-request sharing, and LRU eviction of cached blocks.

    Block lifecycle::

        free --alloc()--> private (refcount 1, mutable, unregistered)
        private --register(key)--> shared (immutable; refcount may reach 0)
        shared --acquire_cached(key)--> refcount += 1     (a prefix hit)
        any --release_block()--> refcount -= 1
            at 0: registered -> evictable LRU, unregistered -> free list
        evictable --alloc() under pressure--> evicted (deregistered, reused)

    Invariants (pinned by the property suite): every block is in exactly one
    of {free, evictable, referenced}; a block is never handed out while
    referenced; registered blocks are never written (writers go through
    :meth:`writable`, which copies-on-write); eviction only happens at
    refcount 0. Pure Python over plain data."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"bad pool geometry ({num_blocks}, {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(num_blocks))
        self._ref = [0] * num_blocks
        self._key_of: List[Optional[bytes]] = [None] * num_blocks
        self._by_key: Dict[bytes, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # evictable
        self.evictions = 0
        self.cow_copies = 0
        self.shared_hits = 0

    # ------------------------------------------------------------- accounting

    def state_signature(self) -> tuple:
        """The allocator's complete observable state as one hashable value:
        free-list order, refcounts, registered keys, LRU order, and the
        eviction/CoW/hit counters. Tensor-parallel serving relies on block
        ids meaning the SAME thing on every device — the pool shards by
        heads, never by block — so two allocators driven by the same op
        sequence must stay signature-identical step for step; the sharded
        scheduler property test asserts exactly that."""
        return (tuple(self._free), tuple(self._ref), tuple(self._key_of),
                tuple(sorted(self._by_key.items())), tuple(self._lru),
                self.evictions, self.cow_copies, self.shared_hits)

    def available(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._lru)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def registered(self, block: int) -> bool:
        return self._key_of[block] is not None

    def key_of(self, block: int) -> Optional[bytes]:
        """The content key this block is registered under (None: private).
        Preemption swap-out uses it to split a victim's blocks into
        re-acquirable-by-key (just release — resume matches the prefix
        registry) vs host-copy (private content only this request holds)."""
        return self._key_of[block]

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case private blocks for a request (no sharing assumed)."""
        return -(-(prompt_len + max_new) // self.block_size)

    # ------------------------------------------------------------- allocation

    def alloc(self) -> int:
        """A private mutable block (refcount 1). Evicts the LRU cached block
        when the free list is empty; raises when nothing is allocatable."""
        if self._free:
            b = self._free.popleft()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)
            assert self._ref[b] == 0, "evicting a referenced block"
            del self._by_key[self._key_of[b]]
            self._key_of[b] = None
            self.evictions += 1
        else:
            raise RuntimeError("KV block pool exhausted (no free or "
                               "evictable blocks)")
        assert self._ref[b] == 0, "allocating a referenced block"
        self._ref[b] = 1
        return b

    def release_block(self, block: int) -> None:
        assert self._ref[block] > 0, f"double-free of block {block}"
        self._ref[block] -= 1
        if self._ref[block] == 0:
            if self._key_of[block] is not None:
                self._lru[block] = None          # cached: evictable, MRU end
            else:
                self._free.append(block)

    # ---------------------------------------------------------------- sharing

    def acquire_cached(self, key: bytes) -> Optional[int]:
        """Take a reference on the registered block for ``key``, if any."""
        b = self._by_key.get(key)
        if b is None:
            return None
        if self._ref[b] == 0:
            del self._lru[b]
        self._ref[b] += 1
        self.shared_hits += 1
        return b

    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """Acquire the longest registered chain of cumulative prefix keys."""
        out: List[int] = []
        for key in keys:
            b = self.acquire_cached(key)
            if b is None:
                break
            out.append(b)
        return out

    def register(self, key: bytes, block: int) -> bool:
        """Publish a (full, final) prompt block for future prefix hits.
        The block becomes immutable. No-op when the key is already
        registered by another block (the caller's copy stays private)."""
        assert self._ref[block] > 0, "registering an unreferenced block"
        if key in self._by_key:
            return False
        assert self._key_of[block] is None, "re-registering a block"
        self._key_of[block] = key
        self._by_key[key] = block
        return True

    def writable(self, block: int) -> Tuple[int, bool]:
        """Copy-on-write handshake: returns (block', copied). A private
        mutable block comes back unchanged; a registered (immutable) or
        multiply-referenced block is replaced by a fresh private block —
        the caller must copy the device contents ``block -> block'`` and
        repoint its table entry, after which this allocator drops the
        caller's reference on the original."""
        if self._ref[block] == 1 and self._key_of[block] is None:
            return block, False
        fresh = self.alloc()
        self.release_block(block)
        self.cow_copies += 1
        return fresh, True


def random_trace(n_requests: int, vocab: int, *, seed: int = 0,
                 prompt_lens: Sequence[int] = (4, 8, 16, 32),
                 max_new_range: Tuple[int, int] = (8, 64),
                 arrival_spacing: float = 2.0) -> List[Request]:
    """A reproducible mixed-length trace: staggered arrivals, prompt lengths
    drawn from ``prompt_lens`` (a small set, so serving compiles a bounded
    number of prefill shapes), per-request ``max_new`` uniform over
    ``max_new_range``. Used by the acceptance test and serve_bench."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        p = int(rng.choice(list(prompt_lens)))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, size=(p,), dtype=np.int32),
            max_new=int(rng.integers(max_new_range[0], max_new_range[1] + 1)),
            arrival=float(rng.integers(0, int(arrival_spacing * n_requests) + 1)),
            seed=1000 + rid))
    return reqs


def shared_prefix_trace(n_requests: int, vocab: int, *, prefix_len: int = 32,
                        seed: int = 0,
                        suffix_lens: Sequence[int] = (2, 4, 8),
                        max_new_range: Tuple[int, int] = (8, 32),
                        arrival_spacing: float = 2.0) -> List[Request]:
    """A trace where every prompt opens with the SAME ``prefix_len`` tokens
    (a system prompt / few-shot header) followed by a short private suffix —
    the workload prefix sharing exists for. With block-granular sharing, all
    requests after the first prefill only their suffix (plus at most one
    partial block)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=(prefix_len,), dtype=np.int32)
    reqs = []
    for rid in range(n_requests):
        sfx = rng.integers(0, vocab, size=(int(rng.choice(list(suffix_lens))),),
                           dtype=np.int32)
        reqs.append(Request(
            rid=rid,
            prompt=np.concatenate([prefix, sfx]),
            max_new=int(rng.integers(max_new_range[0], max_new_range[1] + 1)),
            arrival=float(rng.integers(0, int(arrival_spacing * n_requests) + 1)),
            seed=2000 + rid))
    return reqs


def poisson_trace(n_requests: int, vocab: int, *, seed: int = 0,
                  rate: float = 0.5,
                  prompt_lens: Sequence[int] = (4, 8, 16, 32),
                  max_new_range: Tuple[int, int] = (8, 32),
                  classes: Sequence[int] = (0,),
                  class_weights: Optional[Sequence[float]] = None,
                  deadline_slack: Optional[float] = None) -> List[Request]:
    """Memoryless arrivals: inter-arrival gaps exponential at ``rate``
    requests per decode step — the standard open-loop traffic model. Each
    request draws a priority class from ``classes`` (probabilities
    ``class_weights``, uniform when None); with ``deadline_slack`` set, a
    request's deadline is ``slack * max_new`` clock units after arrival (a
    perfectly scheduled request finishes in about ``max_new`` steps, so
    slack is the overload headroom the SLA grants).

    Deterministic: everything comes from ``np.random.default_rng(seed)``
    (the seeded PCG64 stream — no global numpy state), so the same
    (seed, args) reproduce the trace byte-for-byte across runs and xdist
    workers; the determinism test pins this."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    weights = None if class_weights is None else \
        np.asarray(class_weights, np.float64) / np.sum(class_weights)
    reqs = []
    for rid in range(n_requests):
        p = int(rng.choice(list(prompt_lens)))
        max_new = int(rng.integers(max_new_range[0], max_new_range[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, size=(p,), dtype=np.int32),
            max_new=max_new,
            arrival=float(arrivals[rid]),
            seed=3000 + rid,
            priority=int(rng.choice(list(classes), p=weights)),
            deadline=(None if deadline_slack is None
                      else float(deadline_slack * max_new))))
    return reqs


def bursty_trace(n_requests: int, vocab: int, *, seed: int = 0,
                 short_lens: Sequence[int] = (4, 8),
                 short_max_new: Tuple[int, int] = (8, 24),
                 short_spacing: float = 1.0,
                 burst_every: float = 12.0, burst_size: int = 4,
                 long_prompt: int = 96, long_max_new: int = 4,
                 deadline_slack: float = 4.0) -> List[Request]:
    """The adversarial shape chunked prefill exists for: a steady stream of
    short interactive requests (class 0, tight deadlines) with periodic
    bursts of ``burst_size`` long-prompt batch jobs (class 1, loose
    deadlines) landing together every ``burst_every`` steps. Under whole
    prefill each ``long_prompt``-token prompt stalls every in-flight decode
    for its full prefill, spiking interactive TBT/p99; chunked prefill
    bounds the stall at ``prefill_chunk`` tokens per step. Deterministic
    per (seed, args) exactly like :func:`poisson_trace`."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t_short, t_burst = 0.0, float(burst_every)
    while len(reqs) < n_requests:
        rid = len(reqs)
        if t_burst <= t_short and n_requests - len(reqs) >= burst_size:
            for _ in range(min(burst_size, n_requests - len(reqs))):
                reqs.append(Request(
                    rid=len(reqs),
                    prompt=rng.integers(0, vocab, size=(long_prompt,),
                                        dtype=np.int32),
                    max_new=long_max_new, arrival=t_burst,
                    seed=4000 + len(reqs), priority=1,
                    deadline=float(deadline_slack
                                   * (long_max_new + long_prompt))))
            t_burst += burst_every
            continue
        p = int(rng.choice(list(short_lens)))
        max_new = int(rng.integers(short_max_new[0], short_max_new[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, size=(p,), dtype=np.int32),
            max_new=max_new, arrival=t_short,
            seed=4000 + rid, priority=0,
            deadline=float(deadline_slack * max_new)))
        t_short += short_spacing * float(rng.integers(1, 3))
    return reqs


def trace_to_json(requests: Sequence[Request]) -> List[dict]:
    """A trace as plain JSON-serializable data — ``json.dumps`` of this
    round-trips through :func:`trace_from_json` to an identical trace
    (prompts exact int lists, floats preserved exactly by JSON repr), so
    CI overload gates can replay the very same arrivals from a file."""
    return [{"rid": r.rid, "prompt": np.asarray(r.prompt).tolist(),
             "max_new": r.max_new, "arrival": r.arrival, "seed": r.seed,
             "priority": r.priority, "deadline": r.deadline}
            for r in requests]


def trace_from_json(data: Sequence[dict]) -> List[Request]:
    """Inverse of :func:`trace_to_json`."""
    return [Request(rid=int(d["rid"]),
                    prompt=np.asarray(d["prompt"], np.int32),
                    max_new=int(d["max_new"]),
                    arrival=float(d["arrival"]),
                    seed=int(d.get("seed", 0)),
                    priority=int(d.get("priority", 0)),
                    deadline=(None if d.get("deadline") is None
                              else float(d["deadline"])))
            for d in data]
