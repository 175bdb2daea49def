"""GQA attention with a pluggable softmax — where SoftmAP enters the model
(port of the contiguous path of ``src/repro/models/attention.py``).

Causal, sliding-window or full masking, query-chunked prefill and
single-token decode against a contiguous cache. The int8 KV cache and the
paged cache (with the fused paged kernel K2) are later slices: ROADMAP.md
Queue 1 items 7 and 8.
"""

from __future__ import annotations

import torch

from repro_torch.backends import telemetry
from repro_torch.core.softmax_variants import spec_backend
from repro_torch.models.layers import Ctx, apply_rope, dense_apply

_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rope(x, positions, cfg):
    if cfg.rope_type == "none" or positions is None:
        return x
    if cfg.rope_type != "rope":
        raise NotImplementedError(
            f"rope_type {cfg.rope_type!r} is not ported: ROADMAP.md Queue 1 "
            "item 11 (M-RoPE)")
    return apply_rope(x, positions, cfg.rope_theta)


def project_qkv(p, x, cfg, ctx: Ctx, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense_apply(p["wq"], x, ctx).reshape(b, s, h, dh)
    k = dense_apply(p["wk"], x, ctx).reshape(b, s, kv, dh)
    v = dense_apply(p["wv"], x, ctx).reshape(b, s, kv, dh)
    return _rope(q, positions, cfg), _rope(k, positions, cfg), v


def _mask(q_pos, kv_pos, kind: str, window: int):
    """[..., Sq, Skv] bool mask from int position vectors."""
    if kind == "none":
        return None
    rel = q_pos[..., :, None] - kv_pos[..., None, :]
    m = rel >= 0
    if kind == "window":
        m &= rel < window
    return m


def attend(q, k, v, mask, cfg, ctx: Ctx):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D]. mask [B?,Sq,Skv] or None.

    Scores round like the reference's: the einsum of compute-dtype operands
    yields the compute dtype, which is cast to ``cfg.scores_dtype`` and then
    scaled (never an f32 product of bf16 operands); the probabilities go back
    to the compute dtype before PV."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    group = h // kvh
    scale = dh ** -0.5
    qg = q.reshape(b, sq, kvh, group, dh)
    # scores: [B, KV, G, Sq, Skv]
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(
        _SCORE_DTYPES[cfg.scores_dtype]) * scale
    backend = spec_backend(cfg.softmax)
    # one AP per attention head (KV*G of them)
    telemetry.record_softmax(backend, scores.shape, heads=kvh * group)
    m = None if mask is None else mask[:, None, None, :, :]
    w = backend.apply(scores, mask=m).to(ctx.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def attend_chunked(q, k, v, q_pos, kv_pos, kind, cfg, ctx: Ctx):
    """Query-chunked attention: bounds live score memory to
    [B, H, chunk, Skv]. Exact (full rows per chunk)."""
    b, sq, h, dh = q.shape
    chunk = cfg.attn_chunk
    if chunk <= 0 or sq <= chunk or sq % chunk != 0:
        return attend(q, k, v, _mask(q_pos, kv_pos, kind, cfg.window), cfg, ctx)
    outs = []
    for i in telemetry.scan_range(sq // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        mask = _mask(q_pos[:, sl], kv_pos, kind, cfg.window)
        outs.append(attend(q[:, sl], k, v, mask, cfg, ctx))
    return torch.cat(outs, dim=1)


def attn_apply(p, x, cfg, ctx: Ctx, positions, kind: str = "causal"):
    """Training / prefill self-attention. kind: causal | window | none."""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, ctx, positions)
    out = attend_chunked(q, k, v, positions, positions, kind, cfg, ctx)
    return dense_apply(p["wo"], out.reshape(b, s, -1), ctx)


def cache_write(buf, new, cache_pos):
    """Write ``new`` [B, T, ...] into ``buf`` [B, L, ...] at ``cache_pos``,
    IN PLACE (the reference returns a new buffer; updating the one buffer
    saves a cache copy per token). Returns ``buf``.

    ``cache_pos`` an int: one slice shared by the whole batch, clamped to
    fit like ``lax.dynamic_update_slice``. ``cache_pos`` a ``[B]`` tensor
    (T == 1): each row lands at its own position; a row whose position is out
    of range writes nothing."""
    if isinstance(cache_pos, int):
        t, l_max = new.shape[1], buf.shape[1]
        start = min(max(cache_pos, 0), l_max - t)
        buf[:, start:start + t] = new.to(buf.dtype)
        return buf
    l_max = buf.shape[1]
    hit = (torch.arange(l_max, dtype=torch.int32, device=buf.device)[None, :]
           == cache_pos.to(torch.int32)[:, None])
    hit = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
    buf.copy_(torch.where(hit, new.to(buf.dtype), buf))
    return buf


def valid_upto(l_max: int, cache_pos, window: int = 0, device=None):
    """[1 or B, l_max] validity: positions <= cache_pos (and, with
    ``window``, within the trailing window). ``cache_pos`` an int (the
    result broadcasts over the batch) or a per-row [B] tensor."""
    kv_pos = torch.arange(l_max, dtype=torch.int32, device=device)[None, :]
    pos = cache_pos if isinstance(cache_pos, int) else cache_pos[:, None]
    valid = kv_pos <= pos
    if window:
        valid &= kv_pos > pos - window
    return valid


def attn_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions,
                kind: str = "causal"):
    """Single-token decode against a contiguous cache {"k","v"} [B, L, KV, D]
    (written in place). ``cache_pos``: int or per-row [B] tensor."""
    if "table" in cache or "k_scale" in cache:
        raise NotImplementedError(
            "paged / int8 KV caches are not ported: ROADMAP.md Queue 1 "
            "items 7 and 8")
    b, s, _ = x.shape  # s == 1
    q, k_new, v_new = project_qkv(p, x, cfg, ctx, positions)
    k = cache_write(cache["k"], k_new, cache_pos)
    v = cache_write(cache["v"], v_new, cache_pos)
    l_max = k.shape[1]
    valid = valid_upto(l_max, cache_pos, cfg.window if kind == "window" else 0,
                       device=x.device)
    mask = valid[:, None, :].expand(b, 1, l_max)
    out = attend(q, ctx.cast(k), ctx.cast(v), mask, cfg, ctx)
    y = dense_apply(p["wo"], out.reshape(b, s, -1), ctx)
    return y, {"k": k, "v": v}
