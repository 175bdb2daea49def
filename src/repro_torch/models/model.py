"""Model facade for the dense family (port of ``src/repro/models/model.py``).

  init(generator)                          -> params (nested dict of tensors)
  train_logits(params, batch)              -> logits [B, S, V]
  prefill(params, batch, cache_len)        -> (last_logits [B, 1, V], cache)
  decode_step(params, cache, batch, pos)   -> (logits [B, 1, V], cache)

Batches hold int token tensors on the model's device: {"tokens": [B, S]}
for prefill, {"token": [B, 1]} for a decode step. The cache is updated in
place. Other families (MoE, MLA, SSM, hybrid, encdec, M-RoPE) are later
slices: ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    Ctx, dense_apply, embed_apply, embed_logits, norm_apply, positions_for,
)

_LOGIT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        if (cfg.family != "dense" or cfg.attention != "gqa"
                or cfg.rope_type not in ("rope", "none") or cfg.kv_quant):
            raise NotImplementedError(
                f"{cfg.name}: only the dense GQA family with plain rope and a "
                "bf16 cache is ported; the others follow ROADMAP.md Queue 1 "
                "items 8 and 11")
        self.cfg = cfg
        self.ctx = Ctx(dtype=dtype)
        self.device = resolve_device(device)

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

        def norm(layers):
            lead = (layers,) if layers else ()
            ones = torch.ones(lead + (cfg.d_model,), device=dev)
            if cfg.norm == "layernorm_np":
                return {}
            if cfg.norm == "layernorm":
                return {"scale": ones, "bias": torch.zeros_like(ones)}
            return {"scale": ones}

        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        p = {"embed": {"w": normal((cfg.vocab, d), 0.02)},
             "final_norm": norm(0)}
        if not cfg.tie_embeddings:
            p["head"] = {"w": normal((d, cfg.vocab), 1.0 / math.sqrt(d))}
        p["stack"] = {"layers": {
            "norm1": norm(cfg.n_layers), "norm2": norm(cfg.n_layers),
            "attn": {"wq": dense(d, h * dh, cfg.qkv_bias),
                     "wk": dense(d, kv * dh, cfg.qkv_bias),
                     "wv": dense(d, kv * dh, cfg.qkv_bias),
                     "wo": dense(h * dh, d)},
            "ffn": {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                    "down": dense(cfg.d_ff, d)},
        }}
        return p

    # -------------------------------------------------------------- pieces

    def _embed(self, p, tokens):
        return embed_apply(p["embed"], tokens, self.ctx)

    def _head(self, p, x):
        cfg, ctx = self.cfg, self.ctx
        x = norm_apply(p["final_norm"], x, cfg.norm, ctx)
        if cfg.tie_embeddings:
            logits = embed_logits(p["embed"], x, ctx)
        else:
            logits = dense_apply(p["head"], x, ctx)
        return logits.to(_LOGIT_DTYPES[cfg.logits_dtype])

    # ---------------------------------------------------------------- entry

    def train_logits(self, p, batch):
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        positions = positions_for(tokens.shape, device=tokens.device)
        x = tfm.stack_apply(p["stack"]["layers"], x, self.cfg, self.ctx,
                            positions)
        return self._head(p, x)

    def prefill(self, p, batch, cache_len: int):
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        positions = positions_for(tokens.shape, device=tokens.device)
        x, cache = tfm.stack_prefill(p["stack"]["layers"], x, self.cfg,
                                     self.ctx, positions, cache_len)
        return self._head(p, x[:, -1:]), cache

    def decode_step(self, p, cache, batch, cache_pos):
        """``cache_pos``: the filled length — an int (uniform batch) or a [B]
        int tensor (per-row positions). The cache is written in place and
        returned."""
        token = batch["token"]
        b = token.shape[0]
        if torch.is_tensor(cache_pos) and cache_pos.ndim == 0:
            cache_pos = int(cache_pos)
        if isinstance(cache_pos, int):
            positions = torch.full((b, 1), cache_pos, dtype=torch.int32,
                                   device=token.device)
        else:
            positions = cache_pos.to(torch.int32)[:, None]
        x = self._embed(p, token)
        x, cache = tfm.stack_decode(p["stack"]["layers"], cache, x, cache_pos,
                                    self.cfg, self.ctx, positions)
        return self._head(p, x), cache
