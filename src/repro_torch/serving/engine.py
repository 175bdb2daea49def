"""Batched generation: prefill, then ``decode_step`` per token, then the
sampler (port of ``Engine.generate`` in ``src/repro/serving/engine.py``).

Two modes, as in the reference:

* ``"fused"`` keeps everything on the device until the end: sampled tokens
  and EOS done-flags accumulate in device tensors and the host reads them
  once. (The reference fuses the loop into one ``lax.scan`` dispatch; a CUDA
  graph of the decode step is the analogue here, for a later PR.)
* ``"eager"`` brings each sampled token to the host and feeds it back — one
  host round trip per token; the golden reference for fused.

Both run the same ops in the same order, so their tokens are bitwise equal.
The KV cache is written in place. Continuous batching (``Engine.serve``) is
the next slice: ROADMAP.md Queue 1 item 6.

Cost telemetry: ``report_cost=True`` returns the batch's AP
:class:`CostReport` — the reference's meter, computed by one prefill and one
decode step on the ``meta`` device (shapes only, no compute) in place of
``jax.eval_shape``, the decode step scaled by the generated tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.backends import CostReport, telemetry
from repro_torch.models.model import Model
from repro_torch.serving.sampler import make_sampler


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, prompt + generated]
    prompt_len: int
    steps: int
    cost: Optional[CostReport] = None   # softmax AP cost of the whole batch
    done: Optional[np.ndarray] = None   # [B] bool, only when eos_id is set
    logits: Optional[torch.Tensor] = None  # [B, V] logits of the last step


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta")


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
        params = _to_meta(self.params)
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
