"""Batched generation and continuous-batching serving (port of
``Engine.generate`` and ``Engine.serve`` in ``src/repro/serving/engine.py``).

``generate``: prefill, then ``decode_step`` per token, then the sampler.

Two modes, as in the reference:

* ``"fused"`` keeps everything on the device until the end: sampled tokens
  and EOS done-flags accumulate in device tensors and the host reads them
  once. (The reference fuses the loop into one ``lax.scan`` dispatch; a CUDA
  graph of the decode step is the analogue here, for a later PR.)
* ``"eager"`` brings each sampled token to the host and feeds it back — one
  host round trip per token; the golden reference for fused.

Both run the same ops in the same order, so their tokens are bitwise equal.
The KV cache is written in place.

``serve``: a scheduler (``serving/scheduler.py``) admits timed requests into
a fixed set of decode slots; one slot-batched decode step
(:func:`make_serve_step_fn`: per-slot positions, per-slot generators, per-slot
EOS) runs between admissions. A contiguous cache keeps one stripe per slot;
the paged cache keeps a block pool with per-slot tables and, with
``prefix_share``, reuses resident prompt blocks across requests
(copy-on-write at the boundary block, tail-only prefill). ``kernel="pallas"``
decodes through the fused paged kernel K2 (K4 for MLA). ``prefill_chunk``
commits long prompts in bounded ``prefill_tail`` pieces between decode
steps; ``preemption`` swaps a lower-priority request out to host memory
for a blocked higher class and resumes it later. Each served request's
tokens equal generating it alone with ``mode="eager"``, its own seed and
the same cache length, chunked or preempted or not. Speculative decoding,
tensor parallelism and the other families are later slices (ROADMAP.md
Queue 1 items 10-14); ``ServeOptions`` raises for them.

Cost telemetry: ``report_cost=True`` returns the AP :class:`CostReport` —
the reference's meter, computed by running the model on the ``meta``
device (shapes only, no compute) in place of ``jax.eval_shape``. Serving
attributes a share to every request (``telemetry.SlotCostAttributor``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.backends import CostReport, telemetry
from repro_torch.models import kv_cache
from repro_torch.models.model import Model
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.sampler import make_sampler, sample_slots
from repro_torch.serving.scheduler import (
    BlockAllocator, Request, SlotScheduler, prefix_keys,
)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, prompt + generated]
    prompt_len: int
    steps: int
    cost: Optional[CostReport] = None   # softmax AP cost of the whole batch
    done: Optional[np.ndarray] = None   # [B] bool, only when eos_id is set
    logits: Optional[torch.Tensor] = None  # [B, V] logits of the last step


@dataclasses.dataclass
class RequestResult:
    """One served request: prompt + exactly ``max_new`` generated tokens
    (pad-filled past an early EOS, like the per-request eager row), plus
    scheduling and cost attribution."""
    rid: int
    tokens: np.ndarray          # [prompt_len + max_new]
    prompt_len: int
    done: bool                  # EOS hit (False when eos_id unset)
    admitted_at: float          # serve-clock step time of admission
    finished_at: float          # serve-clock step time of completion
    latency_s: float            # wall seconds, queue entry -> completion
    cost: Optional[CostReport] = None   # this request's attributed share
    shared_prefix: int = 0      # prompt tokens served from shared blocks
    priority: int = 0           # static class (0 = most urgent)
    deadline: Optional[float] = None    # relative completion budget (steps)
    deadline_met: Optional[bool] = None  # None when no deadline was set
    first_token_at: float = 0.0  # serve-clock step time of the first token
    ttft_s: float = 0.0         # wall seconds, queue entry -> first token
    tbt_s: List[float] = dataclasses.field(default_factory=list)
    preempts: int = 0           # times this request was swapped out


@dataclasses.dataclass
class ServeReport:
    """Result of one ``Engine.serve`` run over a trace."""
    results: List[RequestResult]        # ordered by rid
    steps: int                          # decode steps executed
    wall_s: float
    slots: int
    cache_len: int
    cost: Optional[CostReport] = None   # batch meter (prefills + all steps)
    paged: bool = False
    block_size: int = 0
    prefill_tokens: int = 0             # prompt tokens actually prefilled
    shared_prefill_tokens: int = 0      # prompt tokens served from shared blocks
    cow_copies: int = 0
    evictions: int = 0
    prefill_chunk: int = 0              # 0: whole prefill per admission
    max_prefill_per_step: int = 0       # most prompt tokens prefilled in a step
    preemptions: int = 0
    resumes: int = 0
    leaked_blocks: int = 0              # pool blocks unaccounted after drain
    class_latency: Optional[dict] = None  # per-priority-class latency/SLA

    def by_rid(self) -> Dict[int, RequestResult]:
        return {r.rid: r for r in self.results}


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta")


def make_serve_step_fn(model: Model, sample_fn: Callable,
                       eos_id: Optional[int] = None,
                       pad_id: Optional[int] = None) -> Callable:
    """The continuous-batching decode step: (params, cache, tok [S, 1], pos
    [S], generators, done [S]) -> (tok [S] int32, done [S]), the cache
    updated in place. Slots decode together at their own positions
    (``decode_step`` takes the [S] position vector) and sample per slot
    (:func:`sample_slots`); EOS masking runs per slot. Free slots ride along
    parked at ``cache_len`` (their writes are dropped) with no generator,
    and their outputs are ignored."""
    pad = eos_id if pad_id is None else pad_id

    def serve_step(params, cache, tok, pos, generators, done):
        logits, _ = model.decode_step(params, cache, {"token": tok}, pos)
        toks = sample_slots(sample_fn, logits[:, -1], generators)
        if eos_id is not None:
            toks = torch.where(done, pad, toks).to(torch.int32)
            done = done | (toks == eos_id)
        return toks, done

    return serve_step


class Engine:
    def __init__(self, model: Model, params, max_new: int = 64,
                 sampler: str = "greedy", eos_id: Optional[int] = None,
                 pad_id: Optional[int] = None, **sampler_kw):
        self.model = model
        self.params = params
        self.max_new = max_new
        self.eos_id = eos_id
        self.pad_id = eos_id if pad_id is None else pad_id
        self.sample = make_sampler(sampler, **sampler_kw)
        self._meter_cache: dict = {}  # (batch shapes, cache_len, n_new) -> CostReport
        self._meta_params = None
        self._kernel_models: dict = {}   # decode kernel -> Model variant
        self._serve_steps: dict = {}     # decode kernel -> serve step
        self._last_alloc: Optional[BlockAllocator] = None  # pool of the last paged serve

    @torch.no_grad()
    def meter_request(self, batch: dict, cache_len: int, cache,
                      max_new: Optional[int] = None) -> CostReport:
        """The request's softmax AP cost (no device compute): prefill plus
        one decode step at the full cache length — the AP processes whole
        rows with its mask register — times the generated tokens after the
        first. Depends only on shapes, so it is memoized on them."""
        b, p = batch["tokens"].shape
        n_new = self.max_new if max_new is None else max_new
        key = (tuple(sorted((k, tuple(v.shape)) for k, v in batch.items())),
               cache_len, n_new)
        if key in self._meter_cache:
            return self._meter_cache[key]
        params = self._params_meta()
        with telemetry.collect() as acc:
            self.model.prefill(params, _to_meta(batch), cache_len=cache_len)
        cost = acc.total()
        decode_steps = n_new - 1
        if decode_steps > 0:
            step_in = {"token": torch.empty((b, 1), dtype=torch.long,
                                            device="meta")}
            with telemetry.collect() as acc:
                self.model.decode_step(params, _to_meta(cache), step_in, p)
            cost = cost + acc.total().scaled(decode_steps)
        self._meter_cache[key] = cost
        return cost

    def _params_meta(self):
        if self._meta_params is None:
            self._meta_params = _to_meta(self.params)
        return self._meta_params

    @torch.no_grad()
    def generate(self, prompts: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 report_cost: bool = False, mode: str = "fused",
                 max_new: Optional[int] = None,
                 cache_len: Optional[int] = None) -> GenerationResult:
        """prompts: [B, P] int (left-pad upstream; the batch shares cache
        position P). ``generator``: the sampling RNG on the model's device
        (seed 0 when None). ``max_new`` overrides the engine default for
        THIS call, eager mode only (as the reference); ``cache_len`` pins the
        decode cache length (default P + max_new)."""
        if mode not in ("fused", "eager"):
            raise ValueError(f"mode must be 'fused' or 'eager', got {mode!r}")
        n_new = self.max_new if max_new is None else max_new
        if n_new != self.max_new and mode != "eager":
            raise ValueError("per-call max_new override is eager-only")
        dev = self.model.device
        g = generator if generator is not None else torch.Generator(dev).manual_seed(0)
        prompts = np.asarray(prompts)
        b, p = prompts.shape
        cache_len = p + n_new if cache_len is None else cache_len
        if cache_len < p + n_new:
            raise ValueError(f"cache_len {cache_len} < prompt {p} + "
                             f"max_new {n_new}")
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=dev)}
        logits, cache = self.model.prefill(self.params, batch, cache_len=cache_len)
        cost = (self.meter_request(batch, cache_len, cache, n_new)
                if report_cost else None)
        run = self._generate_fused if mode == "fused" else self._generate_eager
        gen, done, last = run(cache, logits, g, b, p, n_new)
        out = np.concatenate([prompts.astype(np.int32), gen], axis=1)
        return GenerationResult(out, prompt_len=p, steps=n_new, cost=cost,
                                done=done if self.eos_id is not None else None,
                                logits=last)

    def _mask_done(self, tok, done):
        if self.eos_id is None:
            return tok, done
        tok = torch.where(done, self.pad_id, tok).to(torch.int32)
        return tok, done | (tok == self.eos_id)

    def _generate_fused(self, cache, logits, g, b: int, p: int, n_new: int):
        dev = self.model.device
        toks = torch.empty((b, n_new), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        tok, done = self._mask_done(self.sample(logits[:, -1], g), done)
        toks[:, 0] = tok
        for t in range(n_new - 1):
            logits, cache = self.model.decode_step(
                self.params, cache, {"token": tok[:, None].long()}, p + t)
            tok, done = self._mask_done(self.sample(logits[:, -1], g), done)
            toks[:, t + 1] = tok
        return toks.cpu().numpy(), done.cpu().numpy(), logits[:, -1]

    def _generate_eager(self, cache, logits, g, b: int, p: int, n_new: int):
        dev = self.model.device
        done = np.zeros((b,), bool)
        nxt = self.sample(logits[:, -1], g).cpu().numpy()
        if self.eos_id is not None:
            done |= nxt == self.eos_id
        toks = [nxt]
        for t in range(n_new - 1):
            step_in = {"token": torch.as_tensor(nxt[:, None], dtype=torch.long,
                                                device=dev)}
            logits, cache = self.model.decode_step(self.params, cache, step_in,
                                                   p + t)
            tok = self.sample(logits[:, -1], g).cpu().numpy()
            if self.eos_id is not None:
                tok = np.where(done, self.pad_id, tok).astype(np.int32)
                done |= tok == self.eos_id
            nxt = tok
            toks.append(nxt)
        return np.stack(toks, axis=1).astype(np.int32), done, logits[:, -1]

    # ------------------------------------------------- continuous batching

    def _meter_prefill(self, p_len: int, cache_len: int) -> CostReport:
        key = ("prefill", p_len, cache_len)
        if key not in self._meter_cache:
            batch = {"tokens": torch.zeros((1, p_len), dtype=torch.long,
                                           device="meta")}
            with telemetry.collect() as acc:
                self.model.prefill(self._params_meta(), batch,
                                   cache_len=cache_len)
            self._meter_cache[key] = acc.total()
        return self._meter_cache[key]

    def _meter_serve_step(self, slots: int, cache_len: int,
                          paged_geom=None) -> CostReport:
        """Softmax AP cost of ONE slot-batched decode step (shapes only,
        memoized). ``paged_geom``: (block_size, num_blocks) meters the
        paged layout — the same softmax shapes, kept honest."""
        key = ("serve_step", slots, cache_len, paged_geom)
        if key not in self._meter_cache:
            cfg = self.model.cfg
            if paged_geom is None:
                struct = kv_cache.cache_zeros(cfg, slots, cache_len, device="meta")
            else:
                struct = kv_cache.paged_cache_zeros(cfg, slots, cache_len,
                                                    *paged_geom, device="meta")
            step_in = {"token": torch.zeros((slots, 1), dtype=torch.long,
                                            device="meta")}
            with telemetry.collect() as acc:
                self.model.decode_step(
                    self._params_meta(), struct, step_in,
                    torch.zeros((slots,), dtype=torch.int32, device="meta"))
            self._meter_cache[key] = acc.total()
        return self._meter_cache[key]

    def _prefix_struct(self, s: int):
        """Shared-prefix entries for metering a tail-only prefill, derived
        from the real pool builders (a one-block pool of block size ``s``
        seen through ``paged_prefix_view``), so it cannot drift from the
        serving layout."""
        struct = kv_cache.paged_cache_zeros(self.model.cfg, 1, s, s, 1,
                                            device="meta")
        return kv_cache.paged_prefix_view(struct, [0], s)

    def _meter_prefill_tail(self, s: int, tail: int) -> CostReport:
        """Softmax AP cost of a tail-only prefill (``tail`` tokens over ``s``
        shared-prefix positions)."""
        key = ("prefill_tail", s, tail)
        if key not in self._meter_cache:
            batch = {"tokens": torch.zeros((1, tail), dtype=torch.long,
                                           device="meta")}
            with telemetry.collect() as acc:
                self.model.prefill_tail(self._params_meta(), batch,
                                        self._prefix_struct(s), prefix_len=s)
            self._meter_cache[key] = acc.total()
        return self._meter_cache[key]

    _INT_KINDS = ("int", "int_jax", "int_pallas", "int_pallas_paged")

    def _kernel_model(self, kernel: str) -> Model:
        """The Model decoding under ``kernel``: ``"jnp"`` is the engine's
        own; ``"pallas"`` swaps the softmax kind to ``int_pallas_paged`` —
        the same Alg. 1 everywhere, with paged decode through K2 (K4 for
        MLA) — and
        shares ``self.params``. Only the Alg.-1 integer family has a fused
        counterpart."""
        if kernel == "jnp":
            return self.model
        if kernel != "pallas":
            raise ValueError(
                f"unknown decode kernel {kernel!r} (expected jnp | pallas)")
        if kernel not in self._kernel_models:
            spec = self.model.cfg.softmax
            if spec is None or spec.kind not in self._INT_KINDS:
                kind = None if spec is None else spec.kind
                raise ValueError(
                    "kernel='pallas' serves the Alg.-1 integer softmax "
                    f"family (one of {self._INT_KINDS}); the requested "
                    f"softmax {kind!r} is not an Alg.-1 dataflow — serve "
                    "it with kernel='jnp'")
            var = dataclasses.replace(spec, kind="int_pallas_paged")
            self._kernel_models[kernel] = Model(
                self.model.cfg.with_softmax(var), dtype=self.model.ctx.dtype,
                device=self.model.device)
        return self._kernel_models[kernel]

    def _serve_step(self, kernel: str):
        if kernel not in self._serve_steps:
            self._serve_steps[kernel] = make_serve_step_fn(
                self._kernel_model(kernel), self.sample, self.eos_id,
                self.pad_id)
        return self._serve_steps[kernel]

    @torch.no_grad()
    def serve(self, requests: Sequence[Request],
              options: Optional[ServeOptions] = None) -> ServeReport:
        """Continuous-batching serving over a trace of timed arrivals.

        Between decode steps the scheduler admits arrived requests into free
        slots: a batch-1 prefill of the prompt goes into the slot's stripe
        of the ``[slots, cache_len]`` cache, or — ``paged=True`` — through
        the slot's block table into a pool of ``num_blocks`` blocks of
        ``block_size`` tokens. ``prefix_share=True`` reuses resident prompt
        blocks with the same cumulative content (refcounted by a
        :class:`BlockAllocator`; copy-on-write when the forced tail token
        lands in a shared block) and prefills only the unshared tail.
        ``kernel="pallas"`` decodes through the fused paged kernel K2 (K4
        for MLA).
        ``policy="gang"`` admits only whole batches. Each request's tokens
        equal ``generate(prompt[None], generator=Generator().manual_seed(
        request.seed), mode="eager", max_new=request.max_new,
        cache_len=report.cache_len)``. With ``report_cost`` the report
        carries the batch AP meter and each request its attributed share
        (its prefill plus an even split of every step it was active in);
        the shares sum to the batch meter.

        ``prefill_chunk=N`` bounds the prompt tokens prefilled per step: a
        prompt that does not fit the step's budget commits in N-token
        pieces, each a ``prefill_tail`` against the pieces committed so far
        (bitwise equal to one whole prefill), one piece per step for the
        oldest job, interleaved with decode. ``preemption=True`` (paged)
        lets a blocked request of a strictly better class swap a victim
        out: its registered prompt blocks are released (resume re-acquires
        them by content key, or re-prefills the evicted ones), its private
        written blocks are copied to host memory, and its token, position,
        EOS flag and generator are banked, so the resumed stream equals an
        uninterrupted run."""
        opt = ServeOptions() if options is None else options
        slots, policy = opt.slots, opt.policy
        paged, block_size = opt.paged, opt.block_size
        prefill_chunk = opt.prefill_chunk
        reqs = list(requests)
        if not reqs:
            return ServeReport([], 0, 0.0, slots, opt.cache_len or 0, None)
        cfg, dev = self.model.cfg, self.model.device
        if prefill_chunk is not None and not (cfg.family in ("dense", "moe")
                                              and cfg.rope_type != "mrope"):
            raise NotImplementedError(
                f"chunked prefill of the {cfg.family}/{cfg.rope_type} family "
                "(the reference's staged branch) is not ported: ROADMAP.md "
                "Queue 1 item 11")
        params = self.params
        serve_step = self._serve_step(opt.kernel)
        need = max(r.prompt_len + r.max_new for r in reqs)
        C = need if opt.cache_len is None else opt.cache_len
        alloc = None
        num_blocks = opt.num_blocks
        if paged:
            C = -(-C // block_size) * block_size     # round up to block grid
            n_logical = C // block_size
            if num_blocks is None:
                # every slot's worst case, plus one request's worth of slack
                # for the cross-request prefix cache to live in
                num_blocks = slots * n_logical + (n_logical if opt.prefix_share
                                                  else 0)
            alloc = BlockAllocator(num_blocks, block_size)
            self._last_alloc = alloc
            need_max = max(alloc.blocks_needed(r.prompt_len, r.max_new)
                           for r in reqs)
            if num_blocks < need_max:
                raise ValueError(
                    f"num_blocks {num_blocks} cannot fit the largest "
                    f"request (worst case {need_max} blocks of "
                    f"{block_size})")
            sched = SlotScheduler(
                reqs, slots, C, policy=policy,
                admit_ok=lambda r: alloc.available() >= alloc.blocks_needed(
                    r.prompt_len, r.max_new),
                aging=opt.aging, hol_grace=opt.hol_grace)
            cache = kv_cache.paged_cache_zeros(cfg, slots, C, block_size,
                                               num_blocks, device=dev)
        else:
            sched = SlotScheduler(reqs, slots, C, policy=policy,
                                  aging=opt.aging, hol_grace=opt.hol_grace)
            cache = kv_cache.cache_zeros(cfg, slots, C, device=dev)
        attr = telemetry.SlotCostAttributor() if opt.report_cost else None
        geom = (block_size, num_blocks) if paged else None
        step_cost = (self._meter_serve_step(slots, C, geom)
                     if opt.report_cost else None)
        slot_blocks: Dict[int, List[int]] = {}
        shared_of: Dict[int, int] = {}
        tok = np.zeros((slots, 1), np.int64)
        pos = np.full((slots,), C, np.int32)      # parked: no write lands
        done = np.ones((slots,), bool)
        gens: List[Optional[torch.Generator]] = [None] * slots
        counts = {"prefill": 0, "shared": 0, "step": 0, "max": 0}
        # chunked prefill: slot -> prompt-commit job, the oldest advancing
        # one piece per step
        chunk_jobs: "OrderedDict[int, dict]" = OrderedDict()
        # preemption: rid -> host payload (copied blocks) and banked lane
        swap_store: Dict[int, dict] = {}

        wall0 = time.perf_counter()
        queued_wall: Dict[int, float] = {}
        emit_wall: Dict[int, List[float]] = {}    # rid -> wall per emission
        first_at: Dict[int, float] = {}           # rid -> serve clock of TTFT
        results: Dict[int, RequestResult] = {}
        t, steps = 0.0, 0

        def tokens_of(req: Request, lo: int, hi: int):
            return {"tokens": torch.as_tensor(
                np.asarray(req.prompt[None, lo:hi], np.int64), device=dev)}

        def finish(slot: int) -> None:
            st = sched.release(slot)
            r = st.request
            gen = list(st.generated)
            if len(gen) < r.max_new:   # EOS early exit: pad like eager rows
                gen += [int(self.pad_id)] * (r.max_new - len(gen))
            toks = np.concatenate([np.asarray(r.prompt, np.int32),
                                   np.asarray(gen, np.int32)])
            pos[slot] = C
            gens[slot] = None
            if alloc is not None:
                for b in slot_blocks.pop(slot, ()):
                    alloc.release_block(b)
            q0 = queued_wall.get(r.rid, wall0)
            ew = emit_wall.pop(r.rid, [])
            results[r.rid] = RequestResult(
                rid=r.rid, tokens=toks, prompt_len=r.prompt_len,
                done=st.done, admitted_at=st.admitted_at, finished_at=t,
                latency_s=time.perf_counter() - q0,
                cost=attr.report_for(r.rid) if attr else None,
                shared_prefix=shared_of.get(r.rid, 0),
                priority=r.priority, deadline=r.deadline,
                deadline_met=(None if r.deadline is None
                              else (t - r.arrival) <= r.deadline),
                first_token_at=first_at.pop(r.rid, st.admitted_at),
                ttft_s=(ew[0] - q0) if ew else 0.0,
                tbt_s=[b - a for a, b in zip(ew, ew[1:])],
                preempts=st.preempts)

        def paged_admit(req: Request) -> dict:
            """Reserve one request's paged residency: match and refcount the
            shared prefix, copy-on-write a partial boundary block, allocate
            the private blocks, build the table row. The prompt's content
            lands later, whole or in chunks, against these ids."""
            bs = block_size
            P = req.prompt_len
            pkeys = prefix_keys(req.prompt, bs) if opt.prefix_share else []
            shared = alloc.match_prefix(pkeys)
            # always leave >= 1 tail token: the first token is sampled from
            # the tail prefill's last-position logits
            s = min(len(shared) * bs, P - 1)
            keep = -(-s // bs)
            for b in shared[keep:]:
                alloc.release_block(b)
            shared = shared[:keep]
            cow = s > 0 and s % bs != 0
            if cow:
                # position s (the forced tail token) lands inside the shared
                # boundary block: the first divergent write copies it first
                old = shared[-1]
                fresh, copied = alloc.writable(old)
                assert copied, "boundary block was shared, writable must copy"
                kv_cache.paged_copy_block(cache, old, fresh)
                shared[-1] = fresh
            ids = shared + [alloc.alloc() for _ in
                            range(alloc.blocks_needed(P, req.max_new)
                                  - len(shared))]
            row = np.full((C // bs,), alloc.num_blocks, np.int32)
            row[:len(ids)] = np.asarray(ids, np.int32)
            return {"ids": ids, "row": row, "pkeys": pkeys, "keep": keep,
                    "s": s, "cow": cow}

        def paged_register(adm: dict) -> None:
            """Publish the prompt's full blocks once their content is final
            (a whole commit, or a chunked prompt's last piece)."""
            for i, key in enumerate(adm["pkeys"]):
                if i < adm["keep"] and not (adm["cow"]
                                            and i == adm["keep"] - 1):
                    continue    # still the registered original we acquired
                alloc.register(key, adm["ids"][i])

        def paged_commit(slot: int, req: Request, adm: dict, c0: int, c1: int):
            """Prefill prompt positions [c0, c1) — whole when ``c0 == 0``,
            else a tail against the committed or shared prefix — and scatter
            them through the slot's table row. Returns the piece's last
            logits."""
            bs = block_size
            id_arr = np.asarray(adm["ids"], np.int64)
            if c0 == 0:
                logits, slot_cache = self.model.prefill(
                    params, tokens_of(req, 0, c1), cache_len=C)
            else:
                prefix = kv_cache.paged_prefix_view(
                    cache, id_arr[:-(-c0 // bs)], c0)
                logits, slot_cache = self.model.prefill_tail(
                    params, tokens_of(req, c0, c1), prefix, prefix_len=c0)
            wpos = np.arange(c0, c1)
            kv_cache.paged_scatter(cache, slot_cache, slot, adm["row"],
                                   id_arr[wpos // bs], wpos % bs, 0, c1 - c0)
            counts["prefill"] += c1 - c0
            counts["step"] += c1 - c0
            if attr is not None:
                if c0 == 0:
                    attr.record_request(req.rid, self._meter_prefill(c1, C))
                elif c0 == adm["s"]:
                    # the first piece past a shared prefix: log the sharing
                    # savings once
                    attr.record_shared_prefill(
                        req.rid, self._meter_prefill_tail(c0, c1 - c0),
                        self._meter_prefill(c0, C), c0)
                else:
                    attr.record_request(
                        req.rid, self._meter_prefill_tail(c0, c1 - c0))
            return logits

        def contig_commit(slot: int, req: Request, c0: int, c1: int):
            """Contiguous-layout chunk commit: prefill [c0, c1) and write it
            into the slot's stripe."""
            if c0 == 0:
                logits, slot_cache = self.model.prefill(
                    params, tokens_of(req, 0, c1), cache_len=C)
                if attr is not None:
                    attr.record_request(req.rid, self._meter_prefill(c1, C))
            else:
                prefix = kv_cache.slot_prefix_view(cache, slot, c0)
                logits, slot_cache = self.model.prefill_tail(
                    params, tokens_of(req, c0, c1), prefix, prefix_len=c0)
                if attr is not None:
                    attr.record_request(
                        req.rid, self._meter_prefill_tail(c0, c1 - c0))
            kv_cache.slot_scatter(cache, slot_cache, slot, c0, 0, c1 - c0)
            counts["prefill"] += c1 - c0
            counts["step"] += c1 - c0
            return logits

        def activate(slot: int, req: Request, logits) -> None:
            """Sample the first token from the (last) prefill logits with the
            request's own generator and turn the slot into a decode lane."""
            g = torch.Generator(dev).manual_seed(req.seed)
            first = int(self.sample(logits[:, -1], g)[0])
            done0 = self.eos_id is not None and first == self.eos_id
            sched.slots[slot].prefilling = False
            sched.install(slot, first, done0)
            tok[slot, 0] = first
            pos[slot] = req.prompt_len
            gens[slot] = g
            done[slot] = done0
            first_at[req.rid] = t
            emit_wall.setdefault(req.rid, []).append(time.perf_counter())
            if sched.slot_done(slot):
                finish(slot)

        def swap_out(slot: int) -> None:
            """Preempt one victim: release its registered prompt blocks (the
            prefix registry keeps them resident until evicted), copy its
            private written blocks to host memory, park the lane and bank
            the request with its generator."""
            st = sched.slots[slot]
            r = st.request
            # the host arrays are authoritative for the lane's position
            st.pos = int(pos[slot])
            bs = block_size
            ids = slot_blocks.pop(slot)
            pk = prefix_keys(r.prompt, bs) if opt.prefix_share else []
            nwritten = -(-int(st.pos) // bs)     # blocks with live positions
            nreg = 0
            while nreg < min(len(pk), len(ids)) and \
                    alloc.key_of(ids[nreg]) == pk[nreg]:
                nreg += 1
            payload = kv_cache.swap_read(cache, slot, ids[nreg:nwritten])
            for b in ids:
                alloc.release_block(b)
            sched.preempt(slot, t)
            swap_store[r.rid] = {"payload": payload, "nreg": nreg,
                                 "nwritten": nwritten, "gen": gens[slot]}
            gens[slot] = None
            pos[slot] = C
            done[slot] = True

        def resume(slot: int, req: Request) -> None:
            """Swap a preempted request back in: re-acquire its registered
            prompt blocks by content key, re-prefill the evicted ones,
            restore the host-copied blocks and the lane (token, position,
            EOS flag, generator)."""
            meta = swap_store.pop(req.rid)
            st = sched.slots[slot]        # restored by admit()
            bs = block_size
            nblocks = alloc.blocks_needed(req.prompt_len, req.max_new)
            pk = (prefix_keys(req.prompt, bs)[:meta["nreg"]]
                  if opt.prefix_share else [])
            shared = alloc.match_prefix(pk)
            got = len(shared)
            ids = shared + [alloc.alloc() for _ in range(nblocks - got)]
            row = np.full((C // bs,), alloc.num_blocks, np.int32)
            row[:nblocks] = np.asarray(ids, np.int32)
            slot_blocks[slot] = ids
            kv_cache.swap_write(cache, meta["payload"], slot,
                                ids[meta["nreg"]:meta["nwritten"]], row)
            if got < meta["nreg"]:
                # registered blocks evicted while swapped out hold prompt
                # positions only: re-prefill them and publish them again
                # ("s": -1 leaves the sharing meter alone)
                adm = {"ids": ids, "row": row, "s": -1}
                paged_commit(slot, req, adm, got * bs, meta["nreg"] * bs)
                for i in range(got, meta["nreg"]):
                    alloc.register(pk[i], ids[i])
            tok[slot, 0] = st.generated[-1]
            pos[slot] = st.pos
            gens[slot] = meta["gen"]
            done[slot] = st.done

        def handle_admission(slot: int, req: Request) -> None:
            if req.rid in swap_store:
                resume(slot, req)
                return
            P = req.prompt_len
            if alloc is not None:
                adm = paged_admit(req)
                slot_blocks[slot] = adm["ids"]
                shared_of[req.rid] = adm["s"]
                counts["shared"] += adm["s"]
                if prefill_chunk is not None and \
                        counts["step"] + P - adm["s"] > prefill_chunk:
                    sched.slots[slot].prefilling = True
                    chunk_jobs[slot] = {"req": req, "adm": adm,
                                        "committed": adm["s"]}
                    return
                logits = paged_commit(slot, req, adm, adm["s"], P)
                paged_register(adm)
            else:
                if prefill_chunk is not None and \
                        counts["step"] + P > prefill_chunk:
                    sched.slots[slot].prefilling = True
                    chunk_jobs[slot] = {"req": req, "adm": None, "committed": 0}
                    return
                logits, slot_cache = self.model.prefill(
                    params, tokens_of(req, 0, P), cache_len=C)
                for k, leaf in cache.items():    # the slot's stripe
                    leaf[:, slot] = slot_cache[k][:, 0].to(leaf.dtype)
                counts["prefill"] += P
                counts["step"] += P
                if attr is not None:
                    attr.record_request(req.rid, self._meter_prefill(P, C))
            activate(slot, req, logits)

        def advance_chunks() -> None:
            """One step's prompt-commit work: the oldest job commits its
            next ``prefill_chunk`` tokens, and activates on its last."""
            slot, job = next(iter(chunk_jobs.items()))
            req = job["req"]
            P = req.prompt_len
            c0 = job["committed"]
            c1 = min(c0 + prefill_chunk, P)
            if alloc is not None:
                logits = paged_commit(slot, req, job["adm"], c0, c1)
            else:
                logits = contig_commit(slot, req, c0, c1)
            job["committed"] = c1
            if c1 == P:
                if alloc is not None:
                    paged_register(job["adm"])
                del chunk_jobs[slot]
                activate(slot, req, logits)

        while sched.unfinished:
            sched.advance(t)
            counts["step"] = 0
            for r in sched.queue:
                queued_wall.setdefault(r.rid, time.perf_counter())
            while True:
                for slot, req in sched.admit(t):
                    handle_admission(slot, req)
                if not opt.preemption:
                    break
                victim = sched.preempt_victim(t)
                if victim is None:
                    break
                swap_out(victim)
            progressed = False
            if chunk_jobs and (counts["step"] == 0 or not sched.active_slots()):
                # one bounded piece a step, and none in a step whose
                # admissions already prefilled while decode lanes are live
                advance_chunks()
                progressed = True
            active = sched.active_slots()
            if active:
                step_gens = [g if i in active else None
                             for i, g in enumerate(gens)]
                toks_d, done_d = serve_step(
                    params, cache, torch.as_tensor(tok, device=dev),
                    torch.as_tensor(pos, device=dev), step_gens,
                    torch.as_tensor(done, device=dev))
                if self.eos_id is not None:
                    both = torch.stack([toks_d, done_d.to(torch.int32)]).cpu().numpy()
                    toks_np, done_np = both[0], both[1].astype(bool)
                else:
                    toks_np, done_np = toks_d.cpu().numpy(), None
                steps += 1
                now = time.perf_counter()
                if attr is not None:
                    attr.record_step(step_cost, sched.active_requests())
                for slot in active:
                    st = sched.slots[slot]
                    st.generated.append(int(toks_np[slot]))
                    emit_wall.setdefault(st.request.rid, []).append(now)
                    if done_np is not None:
                        st.done = bool(done_np[slot])
                        done[slot] = done_np[slot]
                    tok[slot, 0] = int(toks_np[slot])
                    pos[slot] += 1
                    if sched.slot_done(slot):
                        finish(slot)
                t += 1.0
            elif progressed:
                t += 1.0    # a chunk-only step takes time too
            else:
                nxt = sched.next_arrival()
                if nxt is None:
                    assert not sched.swapped, "swapped requests unreachable"
                    break   # defensive: nothing active, queued, or pending
                t = max(t + 1.0, float(nxt))
            counts["max"] = max(counts["max"], counts["step"])

        ordered = [results[r.rid] for r in sorted(reqs, key=lambda q: q.rid)]
        return ServeReport(
            results=ordered, steps=steps,
            wall_s=time.perf_counter() - wall0, slots=slots, cache_len=C,
            cost=attr.total() if attr else None,
            paged=paged, block_size=block_size if paged else 0,
            prefill_tokens=counts["prefill"],
            shared_prefill_tokens=counts["shared"],
            cow_copies=alloc.cow_copies if alloc else 0,
            evictions=alloc.evictions if alloc else 0,
            prefill_chunk=prefill_chunk or 0,
            max_prefill_per_step=counts["max"],
            preemptions=sched.preemptions, resumes=sched.resumes,
            leaked_blocks=(alloc.num_blocks - alloc.available())
            if alloc else 0,
            class_latency=telemetry.class_latency_summary(ordered))
