"""Hymba-style hybrid block (port of ``src/repro/models/hybrid.py``)
[arXiv:2411.13676].

Each layer runs attention heads and Mamba (SSD) heads in parallel on the
same normalized input; each path's output is RMS-normalized and the two
are averaged before the residual add. Most layers use sliding-window
attention over a ring cache; layers {0, mid, last} use full ("global")
attention over a positional cache (contiguous, or paged through K2).
Hymba's cross-layer KV sharing and meta tokens are not modeled, as in the
reference.
"""

from __future__ import annotations

from repro_torch.models.attention import (
    attn_apply, attn_decode, attn_decode_ring, attn_verify, attn_verify_ring,
)
from repro_torch.models.layers import Ctx, mlp_apply, norm_apply
from repro_torch.models.ssm import ssm_apply, ssm_decode, ssm_verify


def fuse_paths(p, x, a, s, cfg, ctx: Ctx):
    """x + 0.5 * (rmsnorm(a) + rmsnorm(s)), then the MLP's residual."""
    fused = 0.5 * (norm_apply(p["attn_norm"], a, "rmsnorm", ctx)
                   + norm_apply(p["ssm_norm"], s, "rmsnorm", ctx))
    x = x + fused
    return x + mlp_apply(p["mlp"], norm_apply(p["norm2"], x, cfg.norm, ctx), cfg.act, ctx)


def hybrid_block_apply(p, x, cfg, ctx: Ctx, positions, kind: str):
    """kind: "causal" (a global layer) or "window"."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    a = attn_apply(p["attn"], h, cfg, ctx, positions, kind=kind)
    s = ssm_apply(p["ssm"], h, cfg, ctx)
    return fuse_paths(p, x, a, s, cfg, ctx)


def hybrid_block_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, kind: str):
    """One token; the layer's {"attn", "ssm"} cache written in place."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    if kind == "window":
        a, _ = attn_decode_ring(p["attn"], h, cache["attn"], cache_pos, cfg, ctx,
                                positions, cfg.window)
    else:
        a, _ = attn_decode(p["attn"], h, cache["attn"], cache_pos, cfg, ctx, positions)
    s, _ = ssm_decode(p["ssm"], h, cache["ssm"], cfg, ctx)
    return fuse_paths(p, x, a, s, cfg, ctx), cache


def hybrid_block_verify(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, kind: str):
    """Multi-token (speculative verify) step: a full layer's attention runs
    the T queries in one pass over its positional cache (written in place);
    a window layer's runs the snapshotting ring scan, and the SSM path the
    snapshotting recurrence. Returns (x [B, T, d], staged {"attn": the
    positional cache or ring snapshots, "ssm": snapshots})."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    if kind == "window":
        a, attn_staged = attn_verify_ring(p["attn"], h, cache["attn"], cache_pos, cfg, ctx,
                                          positions, cfg.window)
    else:
        a, attn_staged = attn_verify(p["attn"], h, cache["attn"], cache_pos, cfg, ctx,
                                     positions)
    s, ssm_staged = ssm_verify(p["ssm"], h, cache["ssm"], cfg, ctx)
    return fuse_paths(p, x, a, s, cfg, ctx), {"attn": attn_staged, "ssm": ssm_staged}


def full_attn_layer_ids(cfg):
    """Hymba's rule: global attention at the first, middle and last layer."""
    if cfg.full_attn_every:
        return tuple(range(0, cfg.n_layers, cfg.full_attn_every))
    return (0, cfg.n_layers // 2, cfg.n_layers - 1)
