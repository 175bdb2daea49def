"""Decode-cache structure (port of the dense family of
``src/repro/models/kv_cache.py``).

Layout: {"k","v": [L, B, C, KV, Dh]} in ``KV_DTYPE``. Paged and int8
layouts and the other families come with ROADMAP.md Queue 1 items 7, 8
and 11.
"""

from __future__ import annotations

import torch

KV_DTYPE = torch.bfloat16


def cache_zeros(cfg, batch: int, cache_len: int, device=None):
    if cfg.family != "dense" or cfg.attention != "gqa" or cfg.kv_quant:
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention} (kv_quant={cfg.kv_quant}) caches "
            "are not ported: ROADMAP.md Queue 1 items 8 and 11")
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=KV_DTYPE, device=device)}
