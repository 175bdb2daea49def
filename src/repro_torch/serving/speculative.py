"""Draft proposers for speculative decoding on the serving engine (port of
``src/repro/serving/speculative.py``).

The engine's draft-and-verify loop (``Engine.serve`` with
``ServeOptions(speculative=True)``) separates WHERE draft tokens come from
(this module) from HOW they are verified (``Model.verify_step`` and the
verifier of ``serving/sampler.py``). A proposer only has to be cheap and
often right: verification makes the output exact whatever the proposals,
so a bad proposer costs throughput, never correctness.

``NgramProposer`` — prompt-lookup decoding: propose the K tokens that
    followed the most recent earlier occurrence of the current suffix
    n-gram in the request's own token stream (prompt + accepted output).
    Host-side numpy, no device work and no AP cost.

``DraftModelProposer`` — two-model speculation: a small model of the same
    vocab greedily proposes K tokens through its own slot-batched
    contiguous KV cache (seen as a paged pool with an identity table when
    the serve decodes through the fused paged kernel, so the draft runs
    the target's attention kernel). The target only commits a prefix of the
    proposals, so the draft cache needs no rollback: accepted positions
    already hold the right K/V, and rejected ones are masked by the
    position rule and overwritten as positions advance — which is why the
    draft model must come from a positional-cache family. On the card its
    proposal step is one CUDA-graph replay (``serving/graphs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.backends import CostReport, telemetry
from repro_torch.backends.paged_kernel import ALG1_KINDS
from repro_torch.core.softmax_variants import spec_backend
from repro_torch.models import kv_cache
from repro_torch.models.model import Model
from repro_torch.serving.graphs import DecodeState


def ngram_propose(seq: np.ndarray, k: int, max_ngram: int = 3) -> np.ndarray:
    """Prompt-lookup draft: find the most recent earlier occurrence of the
    longest suffix n-gram (n = ``max_ngram`` down to 1) of ``seq`` and
    propose the ``k`` tokens that followed it. Short continuations are
    padded by repeating their last token; with no match at all, the last
    token of ``seq`` is repeated."""
    seq = np.asarray(seq, np.int32)
    n_tot = seq.shape[0]
    for n in range(min(max_ngram, n_tot - 1), 0, -1):
        tail = seq[n_tot - n:]
        starts = np.flatnonzero(seq[:n_tot - n] == tail[0])
        for i in starts[::-1]:
            if i + n < n_tot and np.array_equal(seq[i:i + n], tail):
                cont = seq[i + n:i + n + k]
                out = np.empty((k,), np.int32)
                m = cont.shape[0]
                out[:m] = cont
                if m < k:
                    out[m:] = cont[-1] if m else seq[-1]
                return out
    return np.full((k,), seq[-1], np.int32)


class _NgramIndex:
    """Incremental suffix-n-gram index over one request's token stream.

    For each n it keeps the (latest, previous) start positions of every
    n-gram seen, updated in O(max_ngram) per appended token, so a propose
    round is an O(max_ngram + k) lookup instead of a rescan of the whole
    stream. ``propose`` returns exactly what :func:`ngram_propose` computes
    on the full sequence: the latest registration of the current suffix
    gram is the suffix itself, so the previous one is the most recent
    earlier occurrence."""

    def __init__(self, max_ngram: int):
        self.max_ngram = max_ngram
        self.toks: List[int] = []
        self._last: List[Dict[tuple, tuple]] = [{} for _ in range(max_ngram + 1)]

    def extend(self, tokens) -> None:
        for t in tokens:
            self.toks.append(int(t))
            n_tot = len(self.toks)
            for n in range(1, min(self.max_ngram, n_tot) + 1):
                d = self._last[n]
                g = tuple(self.toks[-n:])
                prev = d.get(g)
                d[g] = (n_tot - n, prev[0] if prev else None)

    def propose(self, k: int) -> np.ndarray:
        toks = self.toks
        n_tot = len(toks)
        for n in range(min(self.max_ngram, n_tot - 1), 0, -1):
            entry = self._last[n].get(tuple(toks[-n:]))
            if entry is None:
                continue
            start = entry[1] if entry[0] == n_tot - n else entry[0]
            if start is None:
                continue
            cont = toks[start + n:start + n + k]
            out = np.empty((k,), np.int32)
            m = len(cont)
            out[:m] = cont
            if m < k:
                out[m:] = cont[-1] if m else toks[-1]
            return out
        return np.full((k,), toks[-1], np.int32)


class NgramProposer:
    """Host-side prompt-lookup drafting (no device state). The engine feeds
    committed tokens through :meth:`observe`; each slot keeps an
    incremental n-gram index."""

    kind = "ngram"

    def __init__(self, k: int, max_ngram: int = 3):
        if k < 1:
            raise ValueError(f"draft_k must be >= 1, got {k}")
        self.k = k
        self.max_ngram = max_ngram

    def begin(self, slots: int, cache_len: int, kernel: str = "jnp",
              block_size: Optional[int] = None) -> None:
        self._slots = slots
        self._index: Dict[int, _NgramIndex] = {}

    def admit(self, slot: int, prompt: np.ndarray, first_token: int, pos: int) -> None:
        idx = _NgramIndex(self.max_ngram)
        idx.extend(prompt)
        idx.extend([first_token])
        self._index[slot] = idx

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        self._index[slot].extend(tokens)

    def release(self, slot: int) -> None:
        self._index.pop(slot, None)

    def meter_round(self) -> Optional[CostReport]:
        return None     # host lookup: zero AP cost

    def propose(self, active: Sequence[int], tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        out = np.zeros((self._slots, self.k), np.int32)
        for slot in active:
            out[slot] = self._index[slot].propose(self.k)
        return out


class DraftModelProposer:
    """Greedy draft proposals from a small model sharing the target's vocab.

    Keeps a slot-batched contiguous cache shaped like the target's serving
    slots, and one proposal step over fixed storage (a ``DecodeState``:
    the token and position of every slot in one buffer; the step decodes,
    takes the argmax, writes it back as the next input, advances the
    position and shifts it into a [slots, K] output buffer). One
    ``propose`` round runs that step K times — K CUDA-graph replays on the
    card — and reads the K proposals back once. The engine drives it with
    its own host-side token and position lanes; the draft K/V at every
    position below a slot's position is right by induction, because the
    accepted tokens ARE the draft's own proposals."""

    kind = "draft_model"

    def __init__(self, model, params, k: int):
        if k < 1:
            raise ValueError(f"draft_k must be >= 1, got {k}")
        cfg = model.cfg
        if cfg.family not in ("dense", "moe") or cfg.rope_type == "mrope":
            raise ValueError(
                "draft models must come from the positional-cache families "
                "(dense/moe, incl. MLA attention) with scalar-position rope: "
                "recurrent SSM/hybrid state cannot roll back a rejected "
                f"draft (got family {cfg.family!r})")
        self.model = model
        self.params = params
        self.k = k
        self.cuda_graphs = True     # the engine's setting: False runs op by op
        self._states: Dict[tuple, DecodeState] = {}
        self._paged = None          # the int_pallas_paged variant, built on first use
        self._stripes: Dict[tuple, dict] = {}   # state key -> its contiguous cache
        self._meter: dict = {}

    def begin(self, slots: int, cache_len: int, kernel: str = "jnp",
              block_size: Optional[int] = None) -> None:
        """A zeroed cache for a serve of ``slots`` x ``cache_len`` with the
        serve's decode ``kernel`` (and, for ``"pallas"``, its
        ``block_size``): the state of that shape, kept across serves (its
        storage fixed for the graph), reset to ``cache_zeros``."""
        self._slots, self._cache_len = slots, cache_len
        paged = kernel == "pallas" and self._paged_model() is not None
        key = (slots, cache_len, block_size if paged else None)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = self._new_state(slots, cache_len, key[2])
        else:
            st.reset_cache()
        self._st, self._st_stripes = st, self._stripes[key]
        self._written: Dict[int, int] = {}       # per slot: positions < w written
        self._tail: Dict[int, List[int]] = {}    # last two committed tokens

    def _paged_model(self):
        """The draft model with ``int_pallas_paged`` (its paged decode
        through K2, or K4 for MLA), sharing its params, when its softmax is
        Alg. 1; else None (it decodes as it is)."""
        spec = self.model.cfg.softmax
        if spec is None or spec.kind not in ALG1_KINDS:
            return None
        if self._paged is None:
            var = dataclasses.replace(spec, kind="int_pallas_paged")
            self._paged = Model(self.model.cfg.with_softmax(var),
                                dtype=self.model.ctx.dtype, device=self.model.device)
        return self._paged

    def _new_state(self, slots: int, cache_len: int, block_size: Optional[int]) -> DecodeState:
        """The proposal step's state. With a ``block_size`` (a serve whose
        target decodes through the fused paged kernel) the draft decodes
        through it too, over its contiguous stripes seen as a pool with an
        identity table (``kv_cache.contiguous_as_paged``): a draft that is
        the target then computes the bits the target's decode step does."""
        model, params, dev = self.model, self.params, self.model.device
        stripes = kv_cache.cache_zeros(model.cfg, slots, cache_len, device=dev)
        cache = stripes
        if block_size is not None:
            model = self._paged_model()
            cache = kv_cache.contiguous_as_paged(stripes, block_size)
        lanes = torch.zeros((2, slots), dtype=torch.long, device=dev)   # token, position
        outs = torch.zeros((slots, self.k), dtype=torch.long, device=dev)

        def step():
            logits, _ = model.decode_step(params, cache, {"token": lanes[0][:, None]},
                                          lanes[1])
            nxt = torch.argmax(logits[:, -1], dim=-1)
            lanes[0].copy_(nxt)
            lanes[1].add_(1)
            outs.copy_(torch.cat([outs[:, 1:], nxt[:, None]], dim=1))
            return outs

        self._stripes[(slots, cache_len, block_size)] = stripes
        return DecodeState(cache, (lanes, outs), step, lambda out, g: out, draws=False,
                           model=model)

    def _graphed(self) -> bool:
        return (self.cuda_graphs and self.model.device.type == "cuda"
                and spec_backend(self._st.model.cfg.softmax).capturable)

    def admit(self, slot: int, prompt: np.ndarray, first_token: int, pos: int) -> None:
        tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=self.model.device)
        _, slot_cache = self.model.prefill(self.params, {"tokens": tokens},
                                           cache_len=self._cache_len)
        for k, leaf in self._st_stripes.items():    # the slot's stripe
            leaf[:, slot] = slot_cache[k][:, 0].to(leaf.dtype)
        self._written[slot] = pos            # prefill covered 0 .. P-1
        self._tail[slot] = [int(prompt[-1]), int(first_token)]

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        self._tail[slot] = (self._tail[slot] + [int(t) for t in tokens])[-2:]

    def release(self, slot: int) -> None:
        # stale rows are masked by position and re-prefilled on admit
        self._written.pop(slot, None)
        self._tail.pop(slot, None)

    def meter_round(self) -> Optional[CostReport]:
        """AP softmax cost of ONE propose round (K slot-batched draft decode
        steps) — what the telemetry charges as 'draft' work; the occasional
        catch-up step is folded into the same K-step estimate. Shapes only
        (the model on the ``meta`` device), memoized."""
        from repro_torch.serving.engine import _to_meta

        key = (self._slots, self._cache_len)
        if key not in self._meter:
            struct = kv_cache.cache_zeros(self.model.cfg, self._slots, self._cache_len,
                                          device="meta")
            with telemetry.collect() as acc:
                self.model.decode_step(
                    _to_meta(self.params), struct,
                    {"token": torch.zeros((self._slots, 1), dtype=torch.long, device="meta")},
                    torch.zeros((self._slots,), dtype=torch.int32, device="meta"))
            self._meter[key] = acc.total().scaled(self.k)
        return self._meter[key]

    def propose(self, active: Sequence[int], tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        st, graphed = self._st, self._graphed()
        lanes = st.buffers[0]
        # catch-up: a FULLY accepted round commits K+1 tokens but the K
        # proposal steps wrote only K draft entries, leaving position pos-1
        # (the second-to-last committed token) unwritten — feed it now,
        # parking the slots that need no catch-up out of range. At most one
        # position per slot can be behind (n_emit <= K+1): one step.
        behind = [s for s in active if int(pos[s]) > self._written.get(s, int(pos[s]))]
        if behind:
            host = np.zeros((2, self._slots), np.int64)
            host[1] = self._cache_len
            for s in behind:
                host[0, s] = self._tail[s][-2]
                host[1, s] = pos[s] - 1
            lanes.copy_(torch.from_numpy(host))
            st.run(graphed)
        lanes.copy_(torch.from_numpy(np.stack([np.asarray(tok)[:, 0],
                                               np.asarray(pos)]).astype(np.int64)))
        for _ in range(self.k):
            outs = st.run(graphed)
        for s in active:     # [tok, d1 .. d_{K-1}] landed at pos .. pos+K-1
            self._written[s] = int(pos[s]) + self.k
        return outs.cpu().numpy().astype(np.int32)


def make_proposer(draft: str, k: int, *, max_ngram: int = 3, draft_model=None,
                  draft_params=None):
    """Resolve the ``ServeOptions.draft`` option: "ngram" (default) or
    "model" (requires ``draft_model`` / ``draft_params``). A ready proposer
    object passes through."""
    if hasattr(draft, "propose"):
        return draft
    if draft == "ngram":
        return NgramProposer(k, max_ngram=max_ngram)
    if draft == "model":
        if draft_model is None or draft_params is None:
            raise ValueError('draft="model" requires draft_model and '
                             'draft_params')
        return DraftModelProposer(draft_model, draft_params, k)
    raise ValueError(f"unknown draft proposer {draft!r}; "
                     "available: ngram, model")
