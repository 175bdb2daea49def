"""Model facade for the dense family, GQA or MLA attention (port of
``src/repro/models/model.py``).

  init(generator)                          -> params (nested dict of tensors)
  train_logits(params, batch)              -> (logits [B, S, V], aux)
  prefill(params, batch, cache_len)        -> (last_logits [B, 1, V], cache)
  prefill_tail(params, batch, prefix, s)   -> (last_logits [B, 1, V], tail cache)
  decode_step(params, cache, batch, pos)   -> (logits [B, 1, V], cache)
  verify_step(params, cache, batch, pos)   -> (logits [B, T, V], staged cache)
  verify_commit(staged, n_accept, pos, T)  -> cache (rejected tail cleared)

Batches hold int token tensors on the model's device: {"tokens": [B, S]}
for prefill, {"token": [B, 1]} for a decode step, {"token": [B, T]} for a
verify step. The cache is updated in
place. Under ``cfg.kv_quant`` the GQA caches hold int8 codes and f32
scales (MLA keeps its bf16 latent cache, as the reference). Other
families (MoE, SSM, hybrid, encdec, M-RoPE) are later slices: ROADMAP.md
Queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.softmax_variants import spec_backend
from repro_torch.device import resolve_device
from repro_torch.models import kv_cache
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import block_positions
from repro_torch.models.layers import (
    Ctx, dense_apply, embed_apply, embed_logits, norm_apply, positions_for,
)
from repro_torch.models.mla import mla_dense_shapes

_LOGIT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Prefill products on the card take at least this many rows, zero-padded.
# cuBLAS picks a split-K kernel for a product of 128 rows or fewer over a
# long inner dimension (olmo-1b's and llama2-7b's down projections), which
# sums in another order, so a prompt committed in chunk pieces would get
# other K/V than the whole prompt; from 200 rows up each row comes out with
# the same bits whatever the row count (probes/prefill_rows.py).
PREFILL_MIN_ROWS = 256
# The down projection and the norms of a decode step and of a speculative
# verify block take at least this many rows on the card, zero-padded, so a
# verified token gets the bits the plain decode step gives it. At a verify
# block's 40 rows olmo-1b's down projection splits its sum in another order
# than at the decode step's 8 (cuBLAS's split-K; probes/verify_rows.py).
# Padding it alone left served rows apart on the card, and padding the
# norms too made them bitwise (chip_smoke.py phase 14; probes/verify_step.py
# compares the step op by op and graphed). 64 is the cheapest count the
# probe shows bitwise for phase 14's blocks (8 slots x 5 tokens): a block of
# more rows keeps its own. The step's other products keep their rows.
STEP_MIN_ROWS = 64


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        if (cfg.family != "dense" or cfg.attention not in ("gqa", "mla")
                or cfg.rope_type not in ("rope", "none")):
            raise NotImplementedError(
                f"{cfg.name}: only the dense family (GQA or MLA) with plain rope "
                "is ported; the others follow ROADMAP.md Queue 1 item 11")
        self.cfg = cfg
        self.ctx = Ctx(dtype=dtype)
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self.prefill_ctx = dataclasses.replace(
            self.ctx, min_rows=PREFILL_MIN_ROWS if cuda else 0)
        self.step_ctx = dataclasses.replace(
            self.ctx, step_min_rows=STEP_MIN_ROWS if cuda else 0)

    # ------------------------------------------------------------------ init

    def init(self, generator: Optional[torch.Generator] = None):
        """Random parameters with the reference's init distributions (normal,
        std 0.02 for the embedding and 1/sqrt(d_in) for each dense layer),
        drawn from ``generator`` (on the model's device; seed 0 when None).
        Weight matrices are stored in the compute dtype, norm parameters in
        f32. The torch and JAX generators differ, so parity tests load the
        reference's parameters through ``convert.params_from_numpy``."""
        cfg, dev, dt = self.cfg, self.device, self.ctx.dtype
        g = generator
        if g is None:
            g = torch.Generator(dev).manual_seed(0)

        def normal(shape, std):
            w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
            return (w * std).to(dt)

        def dense(d_in, d_out, bias=False):
            p = {"w": normal((cfg.n_layers, d_in, d_out), 1.0 / math.sqrt(d_in))}
            if bias:
                p["b"] = torch.zeros((cfg.n_layers, d_out), dtype=dt, device=dev)
            return p

        def norm(layers, width=cfg.d_model, kind=cfg.norm):
            lead = (layers,) if layers else ()
            ones = torch.ones(lead + (width,), device=dev)
            if kind == "layernorm_np":
                return {}
            if kind == "layernorm":
                return {"scale": ones, "bias": torch.zeros_like(ones)}
            return {"scale": ones}

        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        p = {"embed": {"w": normal((cfg.vocab, d), 0.02)},
             "final_norm": norm(0)}
        if not cfg.tie_embeddings:
            p["head"] = {"w": normal((d, cfg.vocab), 1.0 / math.sqrt(d))}
        if cfg.attention == "mla":
            attn = {k: dense(*shape) for k, shape in mla_dense_shapes(cfg).items()}
            if cfg.q_lora_rank:
                attn["q_norm"] = norm(cfg.n_layers, cfg.q_lora_rank, "rmsnorm")
            attn["kv_norm"] = norm(cfg.n_layers, cfg.kv_lora_rank, "rmsnorm")
        else:
            attn = {"wq": dense(d, h * dh, cfg.qkv_bias),
                    "wk": dense(d, kv * dh, cfg.qkv_bias),
                    "wv": dense(d, kv * dh, cfg.qkv_bias),
                    "wo": dense(h * dh, d)}
            backend = spec_backend(cfg.softmax)
            if getattr(backend, "learnable", False):
                # learnable softmax parameters (ConSmax beta/gamma): one f32
                # scalar per query head and layer, at the backend cfg's
                # operating point (MLA carries none, as the reference)
                c = backend.cfg
                attn["smx"] = {
                    "beta": torch.full((cfg.n_layers, h), c.beta, device=dev),
                    "gamma": torch.full((cfg.n_layers, h), c.gamma, device=dev)}
        p["stack"] = {"layers": {
            "norm1": norm(cfg.n_layers), "norm2": norm(cfg.n_layers),
            "attn": attn,
            "ffn": {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                    "down": dense(cfg.d_ff, d)},
        }}
        return p

    # -------------------------------------------------------------- pieces

    def _embed(self, p, tokens):
        return embed_apply(p["embed"], tokens, self.ctx)

    def _head(self, p, x, ctx: Optional[Ctx] = None):
        cfg, ctx = self.cfg, self.ctx if ctx is None else ctx
        x = norm_apply(p["final_norm"], x, cfg.norm, ctx)
        if cfg.tie_embeddings:
            logits = embed_logits(p["embed"], x, ctx)
        else:
            logits = dense_apply(p["head"], x, ctx)
        return logits.to(_LOGIT_DTYPES[cfg.logits_dtype])

    # ---------------------------------------------------------------- entry

    def train_logits(self, p, batch):
        """(logits, aux) as the reference returns them: aux is the summed
        auxiliary loss of the layers, a 0-dim f32 zero for the dense and MLA
        families (only MoE layers add one)."""
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        positions = positions_for(tokens.shape, device=tokens.device)
        x = tfm.stack_apply(p["stack"]["layers"], x, self.cfg, self.ctx,
                            positions)
        return self._head(p, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def prefill(self, p, batch, cache_len: int):
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        positions = positions_for(tokens.shape, device=tokens.device)
        x, cache = tfm.stack_prefill(p["stack"]["layers"], x, self.cfg,
                                     self.prefill_ctx, positions, cache_len)
        return self._head(p, x[:, -1:]), cache

    def prefill_tail(self, p, batch, prefix, prefix_len: int):
        """Prefill only the unshared tail of a prompt whose first
        ``prefix_len`` positions are resident in shared cache blocks.
        ``batch["tokens"]`` holds tokens[prefix_len:] ([B, T]); ``prefix`` is
        {"k","v": [L, B, s, KV, Dh]} (int8 with {"k_scale","v_scale": [L,
        B, s, KV]} under ``kv_quant``; MLA: {"c_kv": [L, B, s, r], "k_rope":
        [L, B, s, dr]}) gathered from the pool
        (``kv_cache.paged_prefix_view``). Returns (last_logits, tail cache
        [L, B, T, ...]) — equal to the tail slice of a whole prefill."""
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        positions = positions_for(tokens.shape, device=tokens.device) + prefix_len
        x, cache = tfm.stack_prefill_tail(p["stack"]["layers"], prefix, x,
                                          self.cfg, self.prefill_ctx, positions,
                                          prefix_len)
        return self._head(p, x[:, -1:]), cache

    def decode_step(self, p, cache, batch, cache_pos):
        """``cache_pos``: the filled length — an int or a 0-d int tensor
        (uniform batch), or a [B] int tensor (per-row positions: each
        serving slot decodes at its own offset). A tensor stays on its
        device: the step reads no value back to the host, so a CUDA graph
        can capture it. The cache — contiguous, or paged pools with their
        block table — is written in place and returned."""
        token = batch["token"]
        b = token.shape[0]
        if isinstance(cache_pos, int):
            positions = torch.full((b, 1), cache_pos, dtype=torch.int32,
                                   device=token.device)
        else:
            positions = cache_pos.to(torch.int32).reshape(-1, 1).expand(b, 1)
        x = self._embed(p, token)
        x, cache = tfm.stack_decode(p["stack"]["layers"], cache, x, cache_pos,
                                    self.cfg, self.step_ctx, positions)
        return self._head(p, x, self.step_ctx), cache

    def verify_step(self, p, cache, batch, cache_pos):
        """Multi-token decode for speculative verification: ``batch``
        {"token": [B, T]} (entry 0 the last committed token, entries 1..T-1
        draft proposals) in ONE forward pass at positions ``cache_pos ..
        cache_pos + T-1`` (``cache_pos`` an int, a 0-d or a [B] tensor,
        kept on its device as in ``decode_step``). Returns (logits [B, T,
        V], staged cache): ``logits[:, j]`` is the next-token distribution
        after token j — equal to what T successive ``decode_step`` calls
        give — and the staged cache (the cache, written in place) holds
        every token's entries until :meth:`verify_commit`."""
        token = batch["token"]
        b, t = token.shape
        positions = block_positions(cache_pos, b, t, token.device)
        x = self._embed(p, token)
        x, staged = tfm.stack_verify(p["stack"]["layers"], cache, x, cache_pos,
                                     self.cfg, self.step_ctx, positions)
        return self._head(p, x, self.step_ctx), staged

    def verify_commit(self, staged, n_accept, cache_pos, t: int):
        """Resolve a staged verify cache once the accepted draft depth is
        known, in place: ``n_accept`` [B] int counts accepted draft tokens
        per row (0..t-1; entry 0 of the block is always kept). The rejected
        tail entries (positions ``cache_pos + n_accept + 1 .. cache_pos +
        t - 1``, contiguous or through the block table) are cleared, so the
        committed cache equals one built by stepping only the accepted
        tokens; the next write position is ``cache_pos + n_accept + 1``
        (``kv_cache.commit_staged``)."""
        return kv_cache.commit_staged(staged, n_accept, cache_pos, t)
