"""Dense transformer blocks and the layer loops (port of the dense path of
``src/repro/models/transformer.py``).

Layer parameters are stacked with a leading layer axis, as in the
reference; a Python loop over that axis takes the place of ``lax.scan``.
The loops iterate with ``telemetry.scan_range`` so the AP cost meter
records what the reference's trace-once scan records.
"""

from __future__ import annotations

import torch

from repro_torch.backends import telemetry
from repro_torch.models.attention import (
    attend_chunked,
    attn_apply,
    attn_decode,
    project_qkv,
)
from repro_torch.models.layers import Ctx, dense_apply, mlp_apply, norm_apply


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copy."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def n_stacked(stacked) -> int:
    """Length of the leading layer axis (of the first leaf)."""
    for v in stacked.values():
        if not isinstance(v, dict):
            return v.shape[0]
        if v:
            return n_stacked(v)
    raise ValueError("parameter tree without leaves")


# --------------------------------------------------------------------- blocks


def block_apply(p, x, cfg, ctx: Ctx, positions):
    """Dense pre-norm causal block over a whole sequence."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    x = x + attn_apply(p["attn"], h, cfg, ctx, positions)
    h = norm_apply(p["norm2"], x, cfg.norm, ctx)
    return x + mlp_apply(p["ffn"], h, cfg.act, ctx)


def attn_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int):
    """Causal self-attention over the prompt + the layer's decode cache
    {"k","v"} [B, cache_len, KV, D], zero past the prompt and in the
    dtype K/V were computed in (as the reference)."""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, ctx, positions)
    out = attend_chunked(q, k, v, positions, positions, "causal", cfg, ctx)
    y = dense_apply(p["wo"], out.reshape(b, s, -1), ctx)
    cache = {}
    for name, t in (("k", k), ("v", v)):
        buf = torch.zeros((b, cache_len) + t.shape[2:], dtype=t.dtype,
                          device=t.device)
        buf[:, :s] = t
        cache[name] = buf
    return y, cache


def block_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int):
    """Returns (x, cache) — the decode-ready cache for this layer."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    a, c = attn_prefill(p["attn"], h, cfg, ctx, positions, cache_len)
    x = x + a
    h = norm_apply(p["norm2"], x, cfg.norm, ctx)
    return x + mlp_apply(p["ffn"], h, cfg.act, ctx), c


def block_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions):
    """Single-token decode step. Returns (x, cache) — the cache updated in
    place."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    a, c = attn_decode(p["attn"], h, cache, cache_pos, cfg, ctx, positions)
    x = x + a
    h = norm_apply(p["norm2"], x, cfg.norm, ctx)
    return x + mlp_apply(p["ffn"], h, cfg.act, ctx), c


# ----------------------------------------------------------------- layer loops


def stack_apply(params, x, cfg, ctx: Ctx, positions):
    for i in telemetry.scan_range(n_stacked(params)):
        x = block_apply(layer_params(params, i), x, cfg, ctx, positions)
    return x


def stack_prefill(params, x, cfg, ctx: Ctx, positions, cache_len: int):
    """Returns (x, cache) with cache leaves stacked [L, B, cache_len, ...]."""
    caches = []
    for i in telemetry.scan_range(n_stacked(params)):
        x, c = block_prefill(layer_params(params, i), x, cfg, ctx, positions,
                             cache_len)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def stack_decode(params, caches, x, cache_pos, cfg, ctx: Ctx, positions):
    """One decode step through every layer; each layer writes its slice of
    the stacked cache in place, so the returned cache is ``caches``."""
    for i in telemetry.scan_range(n_stacked(params)):
        x, _ = block_decode(layer_params(params, i), x,
                            layer_params(caches, i), cache_pos, cfg, ctx,
                            positions)
    return x, caches
