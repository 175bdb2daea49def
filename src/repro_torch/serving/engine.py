"""Batched generation and continuous-batching serving (port of
``Engine.generate`` and ``Engine.serve`` in ``src/repro/serving/engine.py``).

``generate``: prefill, then ``decode_step`` per token, then the sampler.

Two modes, as in the reference:

* ``"fused"`` keeps everything on the device until the end: the token,
  position and EOS flags live in device buffers that the step updates
  itself, and the host reads the tokens once. On the card the step is one
  CUDA-graph replay (``serving/graphs.py``), captured once per (batch,
  cache length): the counterpart of the reference's single ``lax.scan``
  dispatch. Greedy sampling and the EOS mask run inside the graph; a
  sampler that draws runs after each replay with the caller's generator.
* ``"eager"`` brings each sampled token to the host and feeds it back — one
  host round trip per token, op by op; the golden reference for fused.

Both run the same ops in the same order, so their tokens are bitwise equal.
The KV cache is written in place.

``serve``: a scheduler (``serving/scheduler.py``) admits timed requests into
a fixed set of decode slots; one slot-batched decode step
(``Engine._serve_state``: per-slot positions, per-slot generators, per-slot
EOS) runs between admissions. A contiguous cache keeps one stripe per slot;
the paged cache keeps a block pool with per-slot tables and, with
``prefix_share``, reuses resident prompt blocks across requests
(copy-on-write at the boundary block, tail-only prefill). ``kernel="pallas"``
decodes through the fused paged kernel K2 (K4 for MLA). ``prefill_chunk``
commits long prompts in bounded ``prefill_tail`` pieces between decode
steps; ``preemption`` swaps a lower-priority request out to host memory
for a blocked higher class and resumes it later. Each served request's
tokens equal generating it alone with ``mode="eager"``, its own seed and
the same cache length, chunked or preempted or not. ``speculative``
decodes in draft-and-verify rounds: a proposer (``serving/speculative.py``:
n-gram lookup or a draft model) guesses K tokens per slot, one verify step
(``Model.verify_step``) scores the K+1-token block of every slot, the
verifier accepts a prefix, and ``Model.verify_commit`` clears the rejected
drafts' K/V (and restores the recurrent snapshots at the accepted depth:
SSM state, window rings); greedy speculative tokens equal the plain
serve's. The recurrent families (SSM, hybrid) serve as the reference's:
they share no prefix, their chunked prefill accrues the step budget and
prefills whole once it covers the prompt (the reference's staged branch),
their slot-resident state swaps out with the private blocks, and a
hybrid's cache length is at least its window (its prefill builds rings
of the window). ``softmax_kind`` serves a softmax variant (the zoo ``consmax`` / ``sole`` /
``mive``, or ``ap_sim``, the functional AP simulator) with the engine's
params: prefills, decode and verify steps and the meter all run under it.
The encoder-decoder (whisper-base) serves as the reference's does: the
contiguous cache with ``kernel="jnp"`` alone, every request carrying
encoder ``frames`` of one shape, whose cross K/V stay in the slot's cache
from admission on. M-RoPE (qwen2-vl-7b) serves plain and paged decode,
text only (the three position streams on the token axis), without
speculative rounds or prefix sharing, and prefills chunked prompts whole.
Both raise for the options the reference refuses, with its messages.
``mesh`` / ``shards=N`` serve tensor-parallel (``serving/sharded.py``):
the dense family's heads (MLA: its latent rank) and the paged pool split
over N shards, driven from this process on one device
(``models/tensor_parallel.py``), with the single-device serve's tokens.

Fixed storage: the decode step of ``generate`` and of ``serve`` runs over
a cache and input buffers kept on the engine per step shape (for serve:
kernel, softmax variant, slots, cache length, block geometry, int8 pool,
and the draft depth of a verify step), reset at the start of every
``serve`` to what ``kv_cache.*_cache_zeros`` gives. On the card the step is
a CUDA graph over that storage, replayed every step (a greedy verify round
too: verify step, verifier and rollback in one replay); admissions,
prefills, chunk pieces, swap-out and resume stay op by op, as the
reference's are separate jitted calls. A softmax backend that reads the
device back on the host (``capturable = False``: ``ap_sim``) cannot be
captured: its steps run op by op, and the serve report says so
(``ServeReport.step_replays`` 0, ``op_by_op`` the reason). The op-by-op
step stays reachable for comparison (``Engine._cuda_graphs = False``).

Cost telemetry: ``report_cost=True`` returns the AP :class:`CostReport` —
the reference's meter, computed by running the model on the ``meta``
device (shapes only, no compute) in place of ``jax.eval_shape``. Serving
attributes a share to every request (``telemetry.SlotCostAttributor``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.backends import CostReport, telemetry
from repro_torch.backends.paged_kernel import ALG1_KINDS
from repro_torch.core.softmax_variants import SoftmaxSpec, spec_backend
from repro_torch.models import kv_cache
from repro_torch.models.model import Model
from repro_torch.serving.graphs import DecodeState
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.sampler import make_sampler, make_spec_verifier, sample_slots
from repro_torch.serving.scheduler import (
    BlockAllocator, Request, SlotScheduler, prefix_keys,
)
from repro_torch.serving.speculative import make_proposer


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
    drafted: int = 0            # speculative: draft tokens proposed for it
    accepted: int = 0           # speculative: draft tokens the verifier accepted
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
    speculative: bool = False
    draft_k: int = 0
    drafted_tokens: int = 0             # draft tokens proposed (all rounds)
    accepted_tokens: int = 0            # draft tokens the verifier accepted
    cost_draft: Optional[CostReport] = None    # batch meter, draft phase
    cost_verify: Optional[CostReport] = None   # batch meter, verify phase
    prefill_chunk: int = 0              # 0: whole prefill per admission
    max_prefill_per_step: int = 0       # most prompt tokens prefilled in a step
    preemptions: int = 0
    resumes: int = 0
    leaked_blocks: int = 0              # pool blocks unaccounted after drain
    class_latency: Optional[dict] = None  # per-priority-class latency/SLA
    softmax_kind: Optional[str] = None  # the serve's variant (None: the model's own)
    step_replays: int = 0               # decode steps (or rounds) replayed as CUDA graphs
    op_by_op: Optional[str] = None      # why the steps ran op by op (None: graphed)

    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens (0.0 when not speculative)."""
        return self.accepted_tokens / max(self.drafted_tokens, 1)

    def by_rid(self) -> Dict[int, RequestResult]:
        return {r.rid: r for r in self.results}


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta")


def _step_inputs(model: Model, tok, b: int, pos):
    """Decode-step inputs for a batch at one position ``pos`` (an int, or a
    0-d tensor kept on its device): an M-RoPE model's three [3, b, 1]
    position streams all sit at it (text-only decode), as the reference's
    ``_step_inputs``."""
    step_in = {"token": tok}
    if model.cfg.rope_type == "mrope":
        if isinstance(pos, int):
            step_in["positions"] = torch.full((3, b, 1), pos, dtype=torch.int32,
                                              device=tok.device)
        else:
            step_in["positions"] = pos.to(torch.int32).reshape(1, 1, 1).expand(3, b, 1)
    return step_in


def _eos_mask(toks, done, eos_id: Optional[int], pad: Optional[int]):
    """Tokens of finished rows become ``pad``; a row emitting EOS is done."""
    if eos_id is None:
        return toks, done
    toks = torch.where(done, pad, toks).to(torch.int32)
    return toks, done | (toks == eos_id)


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
        # a registry sampler's name and options give speculative serving the
        # target distribution; a callable sampler's is opaque
        self._sampler_kind = sampler if isinstance(sampler, str) else None
        self._sampler_kw = dict(sampler_kw)
        self._proposers: dict = {}       # draft-model proposers, kept with their states
        self._meter_cache: dict = {}  # (batch shapes, cache_len, n_new) -> CostReport
        self._meta_params = None
        self._kernel_models: dict = {}   # decode kernel -> Model variant
        self._last_alloc: Optional[BlockAllocator] = None  # pool of the last paged serve
        self._decode_states: dict = {}   # step shape -> DecodeState
        self._mesh_params: dict = {}     # mesh -> every shard's parameter tree
        # decode steps as CUDA-graph replays on the card; False runs them op
        # by op (the comparison the tests and chip_smoke.py make)
        self._cuda_graphs = True

    def _graphed(self, model: Optional[Model] = None) -> bool:
        return self._op_by_op_reason(model) is None

    def _op_by_op_reason(self, model: Optional[Model] = None) -> Optional[str]:
        """Why ``model``'s (default: the engine's) decode steps run op by op,
        or None when they are CUDA-graph replays. A softmax backend that
        reads the device back on the host (``capturable = False``: the
        functional AP simulator) cannot be captured."""
        model = self.model if model is None else model
        if model.device.type != "cuda":
            return f"the model is on {model.device.type}, not a CUDA device"
        if not self._cuda_graphs:
            return "CUDA graphs are off (Engine._cuda_graphs = False)"
        backend = spec_backend(model.cfg.softmax)
        if not backend.capturable:
            return (f"softmax backend {backend.name!r} reads the device back on the host "
                    "in every call: a CUDA graph cannot capture it")
        return None

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
            step_in = _step_inputs(self.model, torch.empty((b, 1), dtype=torch.long,
                                                           device="meta"), b, p)
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
                 cache_len: Optional[int] = None,
                 extra_inputs: Optional[dict] = None) -> GenerationResult:
        """prompts: [B, P] int (left-pad upstream; the batch shares cache
        position P). ``generator``: the sampling RNG on the model's device
        (seed 0 when None). ``max_new`` overrides the engine default for
        THIS call, eager mode only (as the reference); ``cache_len`` pins the
        decode cache length (default P + max_new). ``extra_inputs``: the
        family's further prefill inputs (numpy arrays or tensors), as the
        reference's: the encoder-decoder's ``frames`` [B, S_enc, d], an
        M-RoPE model's ``positions`` [3, B, P] (its decode steps put all
        three streams at the step's position)."""
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
        for k, v in (extra_inputs or {}).items():
            batch[k] = (v.to(dev) if isinstance(v, torch.Tensor)
                        else torch.as_tensor(np.array(v), device=dev))
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
        return _eos_mask(tok, done, self.eos_id, self.pad_id)

    def _generate_state(self, prefill_cache, b: int) -> DecodeState:
        """The fused decode step at the prefill cache's shape (batch b, its
        cache length; a hybrid's ring capacity and an SSM's state are among
        the leaves it keys on) over its own cache and device buffers: token [b, 1],
        position (0-d) and EOS flags [b]. It decodes and advances the
        position; its sampling (with the caller's generator) masks EOS and
        writes the next token and flags back, and gives (tokens [b], last
        logits)."""
        key = ("generate",) + tuple((tuple(v.shape), v.dtype)
                                    for v in kv_cache.tree_leaves(prefill_cache))
        if key not in self._decode_states:
            dev = self.model.device
            cache = kv_cache.tree_map(torch.empty_like, prefill_cache)
            tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
            pos = torch.zeros((), dtype=torch.int32, device=dev)
            done = torch.zeros((b,), dtype=torch.bool, device=dev)
            model, params, sample = self.model, self.params, self.sample
            eos_id, pad = self.eos_id, self.pad_id

            def decode():
                logits, _ = model.decode_step(params, cache, _step_inputs(model, tok, b, pos),
                                              pos)
                pos.add_(1)
                return logits[:, -1]

            def post(last, g):
                new, flags = _eos_mask(sample(last, g), done, eos_id, pad)
                tok.copy_(new[:, None])
                done.copy_(flags)
                return new, last

            self._decode_states[key] = DecodeState(
                cache, (tok, pos, done), decode, post, getattr(sample, "draws", True),
                model=model)
        return self._decode_states[key]

    def _generate_fused(self, cache, logits, g, b: int, p: int, n_new: int):
        dev = self.model.device
        toks = torch.empty((b, n_new), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        new, done = self._mask_done(self.sample(logits[:, -1], g), done)
        toks[:, 0] = new
        last = logits[:, -1]
        if n_new > 1:
            st = self._generate_state(cache, b)
            kv_cache.tree_map(lambda dst, src: dst.copy_(src), st.cache, cache)
            tok, pos, done_buf = st.buffers
            tok.copy_(new[:, None])
            pos.fill_(p)
            done_buf.copy_(done)
            graphed = self._graphed()
            for t in range(1, n_new):
                last = self._fused_step(st, graphed, g, toks, t)
            done, last = done_buf.clone(), last.clone()
        return toks.cpu().numpy(), done.cpu().numpy(), last

    def _fused_step(self, st: DecodeState, graphed: bool, g, toks, col: int):
        """One fused decode step: the state's step (a graph replay on the
        card) and its sampling with the caller's generator, the token into
        column ``col`` of ``toks``. No host sync. Returns the last logits."""
        new, last = st.run(graphed, g)
        toks[:, col] = new
        return last

    def _generate_eager(self, cache, logits, g, b: int, p: int, n_new: int):
        dev = self.model.device
        done = np.zeros((b,), bool)
        nxt = self.sample(logits[:, -1], g).cpu().numpy()
        if self.eos_id is not None:
            done |= nxt == self.eos_id
        toks = [nxt]
        for t in range(n_new - 1):
            step_in = _step_inputs(self.model, torch.as_tensor(nxt[:, None], dtype=torch.long,
                                                               device=dev), b, p + t)
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

    @staticmethod
    def _spec_kind(model: Model) -> Optional[str]:
        spec = model.cfg.softmax
        return None if spec is None else spec.kind

    def _meter_prefill(self, p_len: int, cache_len: int,
                       model: Optional[Model] = None, enc_len: int = 0) -> CostReport:
        model = self.model if model is None else model
        key = ("prefill", p_len, cache_len, enc_len, self._spec_kind(model))
        if key not in self._meter_cache:
            batch = {"tokens": torch.zeros((1, p_len), dtype=torch.long,
                                           device="meta")}
            if enc_len:
                batch["frames"] = torch.zeros((1, enc_len, model.cfg.d_model),
                                              dtype=torch.float32, device="meta")
            if model.cfg.rope_type == "mrope":
                batch["positions"] = torch.zeros((3, 1, p_len), dtype=torch.int32,
                                                 device="meta")
            with telemetry.collect() as acc:
                model.prefill(self._params_meta(), batch, cache_len=cache_len)
            self._meter_cache[key] = acc.total()
        return self._meter_cache[key]

    def _meter_serve_step(self, slots: int, cache_len: int,
                          paged_geom=None, t: int = 1,
                          model: Optional[Model] = None, enc_len: int = 0) -> CostReport:
        """Softmax AP cost of ONE slot-batched step (shapes only, memoized).
        ``t=1`` meters the plain decode step, ``t>1`` the speculative verify
        step over a ``t``-token block (the softmax rows grow from 1 to t
        queries per head). ``paged_geom``: (block_size, num_blocks) meters
        the paged layout — the same softmax shapes, kept honest. ``model``:
        the serve's variant (default: the engine's model). ``enc_len``: the
        encoder-decoder's frames (its cross-attention rows)."""
        model = self.model if model is None else model
        key = ("serve_step", slots, cache_len, paged_geom, t, enc_len, self._spec_kind(model))
        if key not in self._meter_cache:
            cfg = model.cfg
            if paged_geom is None:
                struct = kv_cache.cache_zeros(cfg, slots, cache_len, device="meta",
                                              enc_len=enc_len)
            else:
                struct = kv_cache.paged_cache_zeros(cfg, slots, cache_len,
                                                    *paged_geom, device="meta")
            step_in = {"token": torch.zeros((slots, t), dtype=torch.long,
                                            device="meta")}
            if cfg.rope_type == "mrope":
                step_in["positions"] = torch.zeros((3, slots, t), dtype=torch.int32,
                                                   device="meta")
            fn = model.decode_step if t == 1 else model.verify_step
            with telemetry.collect() as acc:
                fn(
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

    def _meter_prefill_tail(self, s: int, tail: int,
                            model: Optional[Model] = None) -> CostReport:
        """Softmax AP cost of a tail-only prefill (``tail`` tokens over ``s``
        shared-prefix positions)."""
        model = self.model if model is None else model
        key = ("prefill_tail", s, tail, self._spec_kind(model))
        if key not in self._meter_cache:
            batch = {"tokens": torch.zeros((1, tail), dtype=torch.long,
                                           device="meta")}
            with telemetry.collect() as acc:
                model.prefill_tail(self._params_meta(), batch,
                                   self._prefix_struct(s), prefix_len=s)
            self._meter_cache[key] = acc.total()
        return self._meter_cache[key]

    _INT_KINDS = ALG1_KINDS

    def _variant_model(self, softmax_kind: Optional[str]) -> Model:
        """The Model serving under ``ServeOptions.softmax_kind``: the
        engine's config with the softmax kind swapped (precision point
        kept), sharing ``self.params``. Params without learned softmax state
        (``p["smx"]``) serve a learnable variant at the backend cfg's
        default operating point; ``smx`` leaves ride along unused under a
        variant that is not learnable."""
        if softmax_kind is None:
            return self.model
        key = ("softmax", softmax_kind)
        if key not in self._kernel_models:
            spec = self.model.cfg.softmax or SoftmaxSpec()
            var = (spec if spec.kind == softmax_kind
                   else dataclasses.replace(spec, kind=softmax_kind))
            self._kernel_models[key] = Model(
                self.model.cfg.with_softmax(var), dtype=self.model.ctx.dtype,
                device=self.model.device)
        return self._kernel_models[key]

    def _kernel_model(self, kernel: str, softmax_kind: Optional[str] = None) -> Model:
        """The Model decoding under ``kernel``: ``"jnp"`` is the engine's
        own (or its ``softmax_kind`` variant); ``"pallas"`` swaps the softmax
        kind to ``int_pallas_paged`` — the same Alg. 1 everywhere, with
        paged decode through K2 (K4 for MLA) — and shares ``self.params``.
        Only the Alg.-1 integer family has a fused counterpart: any other
        effective softmax raises."""
        base = self._variant_model(softmax_kind)
        if kernel == "jnp":
            return base
        if kernel != "pallas":
            raise ValueError(
                f"unknown decode kernel {kernel!r} (expected jnp | pallas)")
        key = ("pallas", softmax_kind)
        if key not in self._kernel_models:
            spec = base.cfg.softmax
            if spec is None or spec.kind not in self._INT_KINDS:
                kind = None if spec is None else spec.kind
                raise ValueError(
                    "kernel='pallas' serves the Alg.-1 integer softmax "
                    f"family (one of {self._INT_KINDS}); the requested "
                    f"softmax {kind!r} is not an Alg.-1 dataflow — serve "
                    "it with kernel='jnp'")
            var = dataclasses.replace(spec, kind="int_pallas_paged")
            self._kernel_models[key] = Model(
                base.cfg.with_softmax(var), dtype=base.ctx.dtype, device=base.device)
        return self._kernel_models[key]

    def _sharded_params(self, mesh):
        """Every shard's parameter tree for ``mesh``, placed once per mesh
        (``serving.sharded.shard_params`` under the serving rules) and
        shared by every softmax variant and kernel."""
        if mesh not in self._mesh_params:
            from repro_torch.serving.sharded import shard_params

            self._mesh_params[mesh] = shard_params(self.params, self.model.param_axes(),
                                                   self._serving_rules(), mesh)
        return self._mesh_params[mesh]

    def _serving_rules(self):
        from repro_torch.distributed.sharding import ShardingRules, serving_rules

        return serving_rules(ShardingRules(self.model.cfg.sharding_overrides))

    def _step_cache(self, cfg, slots: int, cache_len: int, paged_geom, enc_len: int = 0,
                    mesh=None):
        """A zeroed decode cache of one step shape: contiguous or paged;
        under a mesh placed to the serving layout as the reference's
        (``serving.sharded.place_cache``: a ``Shards`` list, each shard its
        kv-heads or latent rank and its own table)."""
        dev = self.model.device
        if paged_geom is None:
            cache = kv_cache.cache_zeros(cfg, slots, cache_len, device=dev, enc_len=enc_len)
        else:
            cache = kv_cache.paged_cache_zeros(cfg, slots, cache_len, *paged_geom, device=dev)
        if mesh is None:
            return cache
        from repro_torch.serving.sharded import place_cache

        axes = (kv_cache.serve_cache_axes(cfg, slots, cache_len) if paged_geom is None
                else kv_cache.paged_cache_axes(cfg, slots, cache_len, *paged_geom))
        return place_cache(cache, axes, self._serving_rules(), mesh)

    def _serve_state(self, kernel: str, slots: int, cache_len: int,
                     paged_geom, softmax_kind: Optional[str] = None,
                     enc_len: int = 0, mesh=None) -> DecodeState:
        """The serve decode step of one shape — (kernel, softmax variant,
        slots, cache_len, block geometry, int8 pool, encoder frames) — over
        its own cache, reset here to
        ``*_cache_zeros``, and one packed int64 input buffer [3, slots]:
        each slot's token, position and EOS flag. An M-RoPE model's three
        [3, slots, 1] position streams are built from the position row
        inside the step (text-only decode: all three sit at it, as the
        reference's serve step), so a replayed graph reads each step's.
        The encoder-decoder's cache holds each slot's cross K/V, written at
        admission. Slots decode together at
        their own positions and sample per slot (:func:`sample_slots`, with
        each request's generator); EOS masking runs per slot. Free slots ride
        along parked at ``cache_len`` (their writes are dropped) with no
        generator, and their outputs are ignored. The step gives [2, slots]
        int32 (tokens and EOS flags) and the last logits [slots, V]. Under
        a ``mesh`` the step runs every shard over its own cache (one graph
        on the card)."""
        cfg, dev = self.model.cfg, self.model.device
        key = ("serve", kernel, softmax_kind, slots, cache_len, paged_geom, cfg.kv_quant,
               enc_len, mesh)
        st = self._decode_states.get(key)
        if st is not None:
            st.reset_cache()
            return st
        cache = self._step_cache(cfg, slots, cache_len, paged_geom, enc_len, mesh)
        mrope = cfg.rope_type == "mrope"
        inputs = torch.zeros((3, slots), dtype=torch.long, device=dev)
        model = self._kernel_model(kernel, softmax_kind)
        params = self.params if mesh is None else self._sharded_params(mesh)
        sample = self.sample
        eos_id, pad = self.eos_id, self.pad_id

        def decode():
            batch = {"token": inputs[0][:, None]}
            if mrope:
                batch["positions"] = inputs[1].to(torch.int32)[None, :, None].expand(3, -1, 1)
            logits, _ = model.decode_step(params, cache, batch, inputs[1])
            return logits[:, -1]

        def post(last, generators):
            toks = sample_slots(sample, last, generators)
            toks, flags = _eos_mask(toks, inputs[2].to(torch.bool), eos_id, pad)
            return torch.stack([toks, flags.to(torch.int32)]), last

        st = self._decode_states[key] = DecodeState(
            cache, (inputs,), decode, post, getattr(sample, "draws", True), model=model)
        return st

    def _spec_state(self, kernel: str, slots: int, cache_len: int, paged_geom,
                    k: int, softmax_kind: Optional[str] = None, mesh=None) -> DecodeState:
        """The speculative verify round of one shape — (kernel, softmax
        variant, slots, cache_len, block geometry, int8 pool, draft depth
        ``k``) — over its
        own cache, reset here to ``*_cache_zeros``, and one packed int64
        input buffer [slots, k + 2]: each slot's last committed token, its
        ``k`` drafts and its position. The round is ``verify_step`` over
        the [slots, k + 1] block, the verifier (``make_spec_verifier``:
        greedy on the device, else per slot with its generator) and
        ``verify_commit`` at the accepted depth (clearing rejected K/V,
        restoring the recurrent snapshots), all without a host sync:
        greedy, one replay on the card. Parked slots (position
        ``cache_len``) write nothing. It gives [slots, k + 2] int32 (the
        emitted tokens, pad-filled, then n_emit) and the block's logits
        [slots, k + 1, V]."""
        cfg, dev = self.model.cfg, self.model.device
        key = ("spec", kernel, softmax_kind, slots, cache_len, paged_geom, cfg.kv_quant, k,
               mesh)
        st = self._decode_states.get(key)
        if st is not None:
            st.reset_cache()
            return st
        cache = self._step_cache(cfg, slots, cache_len, paged_geom, mesh=mesh)
        inputs = torch.zeros((slots, k + 2), dtype=torch.long, device=dev)
        model = self._kernel_model(kernel, softmax_kind)
        params = self.params if mesh is None else self._sharded_params(mesh)
        t = k + 1
        verify = make_spec_verifier(self._sampler_kind,
                                    pad_id=0 if self.pad_id is None else self.pad_id,
                                    **self._sampler_kw)

        def decode():
            return model.verify_step(params, cache, {"token": inputs[:, :t]}, inputs[:, t])

        def post(step, generators):
            logits, staged = step
            out, n_emit = verify(logits, inputs[:, 1:t], generators)
            model.verify_commit(staged, n_emit - 1, inputs[:, t], t, cache)
            return torch.cat([out, n_emit[:, None]], dim=1), logits

        st = self._decode_states[key] = DecodeState(cache, (inputs,), decode, post,
                                                    verify.draws, model=model)
        return st

    def _serve_decode(self, st: DecodeState, host_inputs: np.ndarray, generators):
        """One serve step (a decode step, or a verify round): the host's
        lanes into the state's input buffer, the step (a graph replay on the
        card) with the slots' generators, and its packed int32 outputs back
        on the host. Returns them with the step's logits (left on the
        device)."""
        st.buffers[0].copy_(torch.from_numpy(host_inputs))
        packed, logits = st.run(self._graphed(st.model), generators)
        return packed.cpu().numpy(), logits

    def _proposer(self, opt: ServeOptions):
        """The draft proposer of a speculative serve. A draft-model proposer
        is kept on the engine per (model, params, depth), so its proposal
        step's storage (and graph) serves every later serve."""
        if self._sampler_kind is None:
            raise ValueError(
                "speculative serving needs a registry sampler (the "
                "verifier must know the target distribution); this "
                "engine was built with a callable sampler")
        key = None
        if opt.draft == "model":
            key = (id(opt.draft_model), id(opt.draft_params), opt.draft_k)
            kept = self._proposers.get(key)
            if kept is not None:
                kept[0].cuda_graphs = self._cuda_graphs
                return kept[0]
        proposer = make_proposer(opt.draft, opt.draft_k, max_ngram=opt.max_ngram,
                                 draft_model=opt.draft_model,
                                 draft_params=opt.draft_params)
        draft_model = getattr(proposer, "model", None)
        if draft_model is not None:
            if draft_model.cfg.vocab != self.model.cfg.vocab:
                raise ValueError(f"draft model vocab {draft_model.cfg.vocab} != "
                                 f"target vocab {self.model.cfg.vocab}")
            proposer.cuda_graphs = self._cuda_graphs
        if key is not None:
            # the model and params ride along so their ids stay theirs
            self._proposers[key] = (proposer, opt.draft_model, opt.draft_params)
        return proposer

    def _serving_mesh(self, opt: ServeOptions, cfg):
        """The serve's mesh, validated (None: single-device). ``shards=N``
        takes the first N visible devices of the model's kind, and raises
        when there are fewer: several shards go on one device only when the
        caller's mesh puts them there."""
        mesh = opt.mesh
        if opt.shards is not None and mesh is None:
            from repro_torch.launch.mesh import make_serving_mesh, visible_devices

            mesh = make_serving_mesh(opt.shards, visible_devices(self.model.device.type))
        if mesh is None:
            return None
        from repro_torch.serving.sharded import validate_serving_mesh

        validate_serving_mesh(cfg, mesh)
        if len({str(d) for d in mesh.device_list()}) != 1:
            from repro_torch.models.tensor_parallel import ONE_DEVICE

            raise NotImplementedError(ONE_DEVICE)
        return mesh

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
        uninterrupted run.

        ``speculative=True`` runs draft-and-verify rounds in place of decode
        steps: the proposer (``draft="ngram"``: prompt lookup; ``"model"``:
        ``draft_model`` / ``draft_params`` propose greedily) guesses
        ``draft_k`` tokens per live slot, and one verify round (``Engine.
        _spec_state``) scores every slot's last token plus drafts, accepts
        a prefix with the verifier, and clears the rejected drafts' K/V.
        The host commits the emissions, truncated at EOS or the request's
        budget exactly where the plain loop would stop. Greedy tokens equal
        the plain serve's; a sampler that draws is exact in distribution.
        It composes with every option above; the report counts drafted and
        accepted tokens and meters the draft and verify phases apart.

        ``softmax_kind`` serves the trace under another registered softmax
        (``_variant_model``: the engine's config with the kind swapped, the
        engine's params), metered by that backend; ``kernel="pallas"``
        rejects a kind that is not Alg. 1.

        ``mesh`` (or ``shards=N``, which builds a 1-D
        :func:`repro_torch.launch.mesh.make_serving_mesh` over the visible
        devices of the model's kind) serves tensor-parallel: attention heads
        (the latent rank for MLA) and the paged pool split over the mesh's
        ``"model"`` axis, each shard holding its heads' slice of every block
        while block tables and the allocator stay replicated or on the
        host. Parameters are placed once per mesh; each decode step and
        verify round is still one step (one graph on the card) over every
        shard. Shard counts that do not divide the heads (or the rank)
        raise up front (``serving.sharded.validate_serving_shards``); the
        tokens equal the single-device serve's, and it composes with paged,
        prefix sharing, chunked prefill, preemption, speculative rounds and
        ``kernel="pallas"``. Several shards share a device only when the
        mesh says so (``make_serving_mesh(n, devices=[dev] * n)``)."""
        opt = ServeOptions() if options is None else options
        slots, policy = opt.slots, opt.policy
        paged, block_size = opt.paged, opt.block_size
        prefill_chunk = opt.prefill_chunk
        speculative, draft_k = opt.speculative, opt.draft_k
        smx_kind = opt.softmax_kind
        model = self._variant_model(smx_kind)
        cfg, dev = model.cfg, model.device
        if cfg.family == "encdec":
            off = [n for n, v in (
                ("paged", paged), ("prefix_share", opt.prefix_share),
                ("speculative", speculative),
                ("prefill_chunk", prefill_chunk is not None),
                ("kernel", opt.kernel != "jnp"),
                ("mesh/shards", opt.mesh is not None or opt.shards is not None),
            ) if v]
            if off:
                raise NotImplementedError(
                    "encdec serving covers the contiguous single-device "
                    "executor (cross K/V is slot-resident in the cache "
                    f"pytree); unsupported option(s): {', '.join(off)}")
        if cfg.rope_type == "mrope" and (speculative or opt.prefix_share):
            raise NotImplementedError(
                "mrope serving covers plain and paged decode; speculative "
                "verify and prefix sharing need scalar-position rope "
                "(Model.verify_step / prefill_tail)")
        reqs = list(requests)
        if not reqs:
            return ServeReport([], 0, 0.0, slots, opt.cache_len or 0, None)
        enc_len = 0
        if cfg.family == "encdec":
            # cross-attention is mask-free, so every request must share one
            # frame geometry: padding a shorter clip would change its rows
            shapes = {None if r.frames is None else tuple(np.asarray(r.frames).shape)
                      for r in reqs}
            if None in shapes or len(shapes) != 1:
                raise ValueError(
                    "encdec serving needs every request to carry encoder "
                    "frames of one shared [enc_len, d_model] shape "
                    f"(cross-attention is mask-free); got {sorted(shapes, key=str)}")
            enc_len = next(iter(shapes))[0]
        mrope = cfg.rope_type == "mrope"
        if opt.kernel != "jnp":
            self._kernel_model(opt.kernel, smx_kind)    # rejects a non-Alg.-1 kind
        if cfg.family == "hybrid" and cfg.kv_quant:
            raise ValueError(
                "hybrid serving from an int8 pool: the reference builds int8 window "
                "rings with scales for the serve cache but bf16 rings without scales "
                "in prefill, so its serve fails on the first admission (contiguous: "
                "a dict key mismatch; paged: KeyError 'k_scale'); the port raises "
                "here instead (generate runs, with bf16 rings)")
        # dense and MoE commit a chunked prompt piece by piece; the recurrent
        # families and M-RoPE (no tail prefill) accrue the same budget and
        # prefill whole once it covers the prompt (the reference's staged
        # branch)
        chunkable = cfg.family in ("dense", "moe") and not mrope
        # SSM state and window rings summarise the whole prefix: nothing to share
        shareable = opt.prefix_share and chunkable
        need = max(r.prompt_len + r.max_new for r in reqs)
        C = need if opt.cache_len is None else opt.cache_len
        if cfg.family == "hybrid":
            # prefill builds window-capacity rings; the slot buffers must match
            C = max(C, cfg.window)
        mesh = self._serving_mesh(opt, cfg)
        params = self.params if mesh is None else self._sharded_params(mesh)
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
        else:
            sched = SlotScheduler(reqs, slots, C, policy=policy,
                                  aging=opt.aging, hol_grace=opt.hol_grace)
        attr = telemetry.SlotCostAttributor() if opt.report_cost else None
        geom = (block_size, num_blocks) if paged else None
        proposer = None
        if speculative:
            proposer = self._proposer(opt)
            proposer.begin(slots, C, opt.kernel, block_size if paged else None)
            state = self._spec_state(opt.kernel, slots, C, geom, draft_k, smx_kind, mesh)
        else:
            state = self._serve_state(opt.kernel, slots, C, geom, smx_kind, enc_len, mesh)
        cache = state.cache
        replays0 = 0 if state.graph is None else state.graph.replays
        step_cost = (self._meter_serve_step(slots, C, geom, model=model, enc_len=enc_len)
                     if opt.report_cost and not speculative else None)
        verify_cost = (self._meter_serve_step(slots, C, geom, t=draft_k + 1, model=model)
                       if opt.report_cost and speculative else None)
        draft_cost = (proposer.meter_round()
                      if opt.report_cost and speculative else None)
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

        def prompt_batch(req: Request, hi: int):
            """The inputs of a prefill of prompt positions [0, hi): the
            tokens and the family's extra stream, as the eager reference's
            ``extra_inputs``: the encoder frames, or M-RoPE's text-only
            streams (all three along the token axis)."""
            b = tokens_of(req, 0, hi)
            if cfg.family == "encdec":
                b["frames"] = torch.as_tensor(np.asarray(req.frames)[None], device=dev)
            elif mrope:
                b["positions"] = torch.arange(hi, dtype=torch.int32, device=dev).expand(
                    3, 1, hi)
            return b

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
            if proposer is not None:
                proposer.release(slot)
            q0 = queued_wall.get(r.rid, wall0)
            ew = emit_wall.pop(r.rid, [])
            results[r.rid] = RequestResult(
                rid=r.rid, tokens=toks, prompt_len=r.prompt_len,
                done=st.done, admitted_at=st.admitted_at, finished_at=t,
                latency_s=time.perf_counter() - q0,
                cost=attr.report_for(r.rid) if attr else None,
                shared_prefix=shared_of.get(r.rid, 0),
                drafted=st.drafted, accepted=st.accepted,
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
            pkeys = prefix_keys(req.prompt, bs) if shareable else []
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
                logits, slot_cache = model.prefill(
                    params, prompt_batch(req, c1), cache_len=C)
            else:
                prefix = kv_cache.paged_prefix_view(
                    cache, id_arr[:-(-c0 // bs)], c0)
                logits, slot_cache = model.prefill_tail(
                    params, tokens_of(req, c0, c1), prefix, prefix_len=c0)
            wpos = np.arange(c0, c1)
            kv_cache.paged_scatter(cache, slot_cache, slot, adm["row"],
                                   id_arr[wpos // bs], wpos % bs, 0, c1 - c0)
            counts["prefill"] += c1 - c0
            counts["step"] += c1 - c0
            if attr is not None:
                if c0 == 0:
                    attr.record_request(req.rid, self._meter_prefill(c1, C, model))
                elif c0 == adm["s"]:
                    # the first piece past a shared prefix: log the sharing
                    # savings once
                    attr.record_shared_prefill(
                        req.rid, self._meter_prefill_tail(c0, c1 - c0, model),
                        self._meter_prefill(c0, C, model), c0)
                else:
                    attr.record_request(
                        req.rid, self._meter_prefill_tail(c0, c1 - c0, model))
            return logits

        def contig_commit(slot: int, req: Request, c0: int, c1: int):
            """Contiguous-layout chunk commit: prefill [c0, c1) and write it
            into the slot's stripe."""
            if c0 == 0:
                logits, slot_cache = model.prefill(
                    params, prompt_batch(req, c1), cache_len=C)
                if attr is not None:
                    attr.record_request(req.rid, self._meter_prefill(c1, C, model))
            else:
                prefix = kv_cache.slot_prefix_view(cache, slot, c0)
                logits, slot_cache = model.prefill_tail(
                    params, tokens_of(req, c0, c1), prefix, prefix_len=c0)
                if attr is not None:
                    attr.record_request(
                        req.rid, self._meter_prefill_tail(c0, c1 - c0, model))
            kv_cache.slot_scatter(cache, slot_cache, slot, c0, 0, c1 - c0)
            counts["prefill"] += c1 - c0
            counts["step"] += c1 - c0
            return logits

        def contig_whole(slot: int, req: Request):
            """Prefill a whole prompt into the slot's stripe of the
            contiguous cache. Returns its last logits."""
            P = req.prompt_len
            logits, slot_cache = model.prefill(params, prompt_batch(req, P), cache_len=C)
            kv_cache.insert_slot(cache, slot_cache, slot)
            counts["prefill"] += P
            counts["step"] += P
            if attr is not None:
                attr.record_request(req.rid, self._meter_prefill(P, C, model, enc_len))
            return logits

        def activate(slot: int, req: Request, logits) -> None:
            """Sample the first token from the (last) prefill logits with the
            request's own generator and turn the slot into a decode lane."""
            g = torch.Generator(dev).manual_seed(req.seed)
            first = int(self.sample(logits[:, -1], g)[0])
            done0 = self.eos_id is not None and first == self.eos_id
            if proposer is not None:
                proposer.admit(slot, np.asarray(req.prompt, np.int32), first,
                               req.prompt_len)
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
            pk = prefix_keys(r.prompt, bs) if shareable else []
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
            if proposer is not None:
                proposer.release(slot)
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
                  if shareable else [])
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
            if proposer is not None:
                proposer.admit(slot, np.asarray(req.prompt, np.int32),
                               st.generated[0], req.prompt_len)
                if len(st.generated) > 1:
                    proposer.observe(slot, st.generated[1:])
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
                                        "committed": adm["s"], "budget": 0}
                    return
                logits = paged_commit(slot, req, adm, adm["s"], P)
                paged_register(adm)
            else:
                if prefill_chunk is not None and \
                        counts["step"] + P > prefill_chunk:
                    sched.slots[slot].prefilling = True
                    chunk_jobs[slot] = {"req": req, "adm": None, "committed": 0,
                                        "budget": 0}
                    return
                logits = contig_whole(slot, req)
            activate(slot, req, logits)

        def advance_chunks() -> None:
            """One step's prompt-commit work: the oldest job commits its
            next ``prefill_chunk`` tokens, and activates on its last. A
            recurrent family's job accrues that budget instead, and
            prefills whole once the budget covers the prompt."""
            slot, job = next(iter(chunk_jobs.items()))
            req = job["req"]
            P = req.prompt_len
            if not chunkable:
                job["budget"] += prefill_chunk
                if job["budget"] < P - job["committed"]:
                    return
                if alloc is not None:
                    logits = paged_commit(slot, req, job["adm"], job["committed"], P)
                    paged_register(job["adm"])
                else:
                    logits = contig_whole(slot, req)
                del chunk_jobs[slot]
                activate(slot, req, logits)
                return
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
            step_gens = [g if i in active else None for i, g in enumerate(gens)]
            if active and speculative:
                drafts = proposer.propose(active, tok, pos)
                both, _ = self._serve_decode(
                    state, np.concatenate([tok, drafts, pos[:, None]], 1).astype(np.int64),
                    step_gens)
                out_np, n_np = both[:, :draft_k + 1], both[:, draft_k + 1]
                steps += 1
                now = time.perf_counter()
                if attr is not None:
                    rids = sched.active_requests()
                    attr.record_step(verify_cost, rids, kind="verify")
                    if draft_cost is not None:
                        attr.record_step(draft_cost, rids, kind="draft")
                for slot in active:
                    st = sched.slots[slot]
                    r = st.request
                    n_emit = int(n_np[slot])
                    budget = r.max_new - len(st.generated)
                    # commit emissions host-side, truncated at EOS or the
                    # request's budget: exactly where the plain loop would
                    # have stopped stepping this slot
                    used = 0
                    ew = emit_wall.setdefault(r.rid, [])
                    for tk in out_np[slot, :n_emit]:
                        st.generated.append(int(tk))
                        ew.append(now)
                        used += 1
                        if self.eos_id is not None and int(tk) == self.eos_id:
                            st.done = True
                            done[slot] = True
                            break
                        if len(st.generated) >= r.max_new:
                            break
                    # only drafts that could have been committed (the budget
                    # is known up front) and were count as proposed and
                    # accepted: acceptance measures useful drafting
                    sched.record_draft(slot, min(draft_k, budget), min(used, n_emit - 1))
                    proposer.observe(slot, out_np[slot, :used])
                    tok[slot, 0] = st.generated[-1]
                    pos[slot] += n_emit
                    if sched.slot_done(slot):
                        finish(slot)
                t += 1.0
            elif active:
                both, _ = self._serve_decode(
                    state, np.stack([tok[:, 0], pos, done]).astype(np.int64),
                    step_gens)
                toks_np = both[0]
                done_np = both[1].astype(bool) if self.eos_id is not None else None
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
            speculative=speculative, draft_k=draft_k if speculative else 0,
            drafted_tokens=sum(r.drafted for r in ordered),
            accepted_tokens=sum(r.accepted for r in ordered),
            cost_draft=attr.total_kind("draft") if attr and speculative else None,
            cost_verify=attr.total_kind("verify") if attr and speculative else None,
            prefill_chunk=prefill_chunk or 0,
            max_prefill_per_step=counts["max"],
            preemptions=sched.preemptions, resumes=sched.resumes,
            leaked_blocks=(alloc.num_blocks - alloc.available())
            if alloc else 0,
            class_latency=telemetry.class_latency_summary(ordered),
            softmax_kind=smx_kind,
            step_replays=(0 if state.graph is None else state.graph.replays) - replays0,
            op_by_op=self._op_by_op_reason(state.model))
