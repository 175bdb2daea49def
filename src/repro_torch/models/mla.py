"""Multi-head Latent Attention, MiniCPM3 / DeepSeek-V2 (port of
``src/repro/models/mla.py``).

Prefill and training up-project the latents to full per-head K/V and run
``attend_chunked`` like MHA, with the scale (dn + dr)^-1/2 and a V of width
dv. Decode is the absorbed form: W_uk folds into the query and W_uv into
the output, so attention runs against the cached latent c_kv [B, L, r] and
the shared rope key [B, L, dr] — r + dr per token instead of 2 H dh. The
speculative verify step (``mla_verify``) is the same over T tokens. On a
paged cache the latents are written through the block table (in place) and
attended by gathering the logical cache, or — for a backend with
``fused_paged_decode`` — with K4 (``kernels/paged_attention``), which walks
the table itself.

The score is the sum of two compute-dtype products, added in f32: that is
how the reference's compiled einsum pair rounds ("semi" semantics), and a
compute-dtype add would move Alg.-1 codes. The gather path, K4 and K4's
plain version all compute it so (``kernels/paged_attention/ref.py:mla_scores``,
shared by the gather path and the plain version).
"""

from __future__ import annotations

import torch

from repro_torch.backends import telemetry
from repro_torch.core.softmax_variants import spec_backend
from repro_torch.kernels.paged_attention.ref import mla_pv, mla_scores
from repro_torch.models.attention import (
    _put, _write_target, attend_chunked, cache_write, cache_write_block, out_proj,
    paged_gather, valid_upto, verify_mask,
)
from repro_torch.models.layers import Ctx, apply_rope, dense_apply, norm_apply


def mla_dense_shapes(cfg):
    """(d_in, d_out) of each projection of one MLA layer, as ``mla_init``
    draws them; ``q_norm`` (with a q_lora rank) and ``kv_norm`` are rmsnorm
    scales of widths q_lora_rank and kv_lora_rank."""
    d, h = cfg.d_model, cfg.n_heads
    r, dr, dn, dv = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    shapes = {}
    if cfg.q_lora_rank:
        shapes["wdq"] = (d, cfg.q_lora_rank)
        shapes["wuq"] = (cfg.q_lora_rank, h * (dn + dr))
    else:
        shapes["wq"] = (d, h * (dn + dr))
    shapes.update(wdkv=(d, r), wkr=(d, dr), wuk=(r, h * dn), wuv=(r, h * dv),
                  wo=(h * dv, d))
    return shapes


def _queries(p, x, cfg, ctx: Ctx, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        ql = norm_apply(p["q_norm"], dense_apply(p["wdq"], x, ctx), "rmsnorm", ctx)
        q = dense_apply(p["wuq"], ql, ctx)
    else:
        q = dense_apply(p["wq"], x, ctx)
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latents(p, x, cfg, ctx: Ctx, positions):
    """c_kv [B, S, r] and the rope key [B, S, 1, dr]."""
    c_kv = norm_apply(p["kv_norm"], dense_apply(p["wdkv"], x, ctx), "rmsnorm", ctx)
    k_rope = dense_apply(p["wkr"], x, ctx)[:, :, None, :]
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta)


def _attend_latents(p, q_nope, q_rope, c_kv, k_rope, q_pos, kv_pos, kind, cfg,
                    ctx: Ctx):
    """Up-project the latents [B, Skv, r] / rope keys [B, Skv, 1, dr] to
    per-head K/V and attend: the shared body of prefill and tail prefill."""
    b, s_kv, _ = c_kv.shape
    t = q_nope.shape[1]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    k_nope = dense_apply(p["wuk"], c_kv, ctx).reshape(b, s_kv, h, dn)
    v = dense_apply(p["wuv"], c_kv, ctx).reshape(b, s_kv, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s_kv, h, dr)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    out = attend_chunked(q, k, v, q_pos, kv_pos, kind, cfg, ctx, (dn + dr) ** -0.5)
    return out_proj(p, out.reshape(b, t, -1), ctx)


def mla_apply(p, x, cfg, ctx: Ctx, positions, kind: str = "causal"):
    """Training / prefill path: up-project the latents, full attention."""
    y, _, _ = _prefill_with_latents(p, x, cfg, ctx, positions, kind)
    return y


def _prefill_with_latents(p, x, cfg, ctx: Ctx, positions, kind: str = "causal"):
    q_nope, q_rope = _queries(p, x, cfg, ctx, positions)
    c_kv, k_rope = _latents(p, x, cfg, ctx, positions)
    y = _attend_latents(p, q_nope, q_rope, c_kv, k_rope, positions, positions,
                        kind, cfg, ctx)
    return y, c_kv, k_rope


def mla_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int):
    """Prefill + the layer's decode cache {"c_kv" [B, cache_len, r],
    "k_rope" [B, cache_len, dr]}, zero past the prompt. The reference
    computes the latents a second time here; once gives the same values."""
    y, c_kv, k_rope = _prefill_with_latents(p, x, cfg, ctx, positions)
    b, s = c_kv.shape[:2]
    cache = {}
    for name, t in (("c_kv", c_kv), ("k_rope", k_rope[:, :, 0])):
        buf = torch.zeros((b, cache_len) + t.shape[2:], dtype=t.dtype, device=t.device)
        buf[:, :s] = t
        cache[name] = buf
    return y, cache


def mla_prefill_tail(p, x, prefix_c, prefix_kr, cfg, ctx: Ctx, positions,
                     prefix_len: int):
    """Prefill the unshared prompt tail against shared-prefix latents
    ``prefix_c`` [B, s, r] / ``prefix_kr`` [B, s, dr] — the values a whole
    prefill cached for those positions, so up-projecting [prefix ++ tail]
    gives the whole prefill's K/V. Returns (y, {"c_kv" [B, T, r], "k_rope"
    [B, T, dr]} tail cache)."""
    t = x.shape[1]
    q_nope, q_rope = _queries(p, x, cfg, ctx, positions)
    c_t, kr_t = _latents(p, x, cfg, ctx, positions)
    c_all = torch.cat([ctx.cast(prefix_c), c_t], dim=1)
    kr_all = torch.cat([ctx.cast(prefix_kr)[:, :, None, :], kr_t], dim=1)
    kv_pos = torch.arange(prefix_len + t, dtype=torch.int32, device=x.device)[None, :]
    y = _attend_latents(p, q_nope, q_rope, c_all, kr_all, positions, kv_pos,
                        "causal", cfg, ctx)
    return y, {"c_kv": c_t, "k_rope": kr_t[:, :, 0]}


def mla_write(cache, c_new, kr_new, cache_pos, positions, block: bool = False):
    """Write the new latents ``c_new`` [B, T, r] and rope keys ``kr_new``
    [B, T, 1, dr] into the latent cache, in place: at ``cache_pos`` (a
    decode step, T 1) or, ``block``, at ``positions`` [B, T] (a verify
    block), contiguous or through the block table. A tensor-parallel shard
    writes its part of the rank (``models/tensor_parallel.py``)."""
    b, t = c_new.shape[:2]
    if "table" in cache:
        # one target for both leaves: they share the block geometry
        target, lands = _write_target(cache["table"], positions if block else cache_pos,
                                      *cache["c_kv"].shape[:2])
        _put(cache["c_kv"], target, lands, c_new.reshape(b * t, -1))
        _put(cache["k_rope"], target, lands, kr_new.reshape(b * t, -1))
    elif block:
        cache_write_block(cache["c_kv"], c_new, cache_pos)
        cache_write_block(cache["k_rope"], kr_new[:, :, 0], cache_pos)
    else:
        cache_write(cache["c_kv"], c_new, cache_pos)
        cache_write(cache["k_rope"], kr_new[:, :, 0], cache_pos)


def mla_read(p, q_nope, q_rope, cache, cache_pos, positions, cfg, ctx: Ctx,
             block: bool = False):
    """Absorbed attention of the queries [B, T, H, ...] over the latent
    cache (whole rank: a tensor-parallel step passes the shards' gathered
    pools), through W_uv and the output projection: K4 on a paged cache
    when the backend sets ``fused_paged_decode``, else over the gathered
    logical cache, masked as the decode step (``cache_pos``) or, ``block``,
    as each query of a verify block (``positions`` [B, T])."""
    b, s = q_nope.shape[:2]
    if "table" in cache:
        table = cache["table"]
        backend = spec_backend(cfg.softmax)
        if getattr(backend, "fused_paged_decode", False):
            if block:
                pos = positions.to(torch.int32)
            elif isinstance(cache_pos, int):
                pos = torch.full((b, 1), cache_pos, dtype=torch.int32, device=q_nope.device)
            else:
                pos = cache_pos.to(torch.int32).expand(b)[:, None]
            return _mla_attend_paged_fused(p, q_nope, q_rope, cache, pos, cfg, ctx,
                                           backend, b, s)
        c_kv = paged_gather(cache["c_kv"], table)
        k_rope = paged_gather(cache["k_rope"], table)
    else:
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    if block:
        mask = verify_mask(c_kv.shape[1], positions)
    else:
        mask = valid_upto(c_kv.shape[1], cache_pos, device=q_nope.device)[:, None, :]
    return _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg, ctx, b, s)


def mla_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions):
    """Absorbed single-token decode against the latent cache {"c_kv" [B, L,
    r], "k_rope" [B, L, dr]} or, with a block table present, the paged pool
    {"c_kv" [NB, BS, r], "k_rope" [NB, BS, dr], "table" [B, n_logical]};
    written in place. ``cache_pos``: int, 0-d or per-row [B] tensor."""
    q_nope, q_rope = _queries(p, x, cfg, ctx, positions)
    c_new, kr_new = _latents(p, x, cfg, ctx, positions)
    mla_write(cache, c_new, kr_new, cache_pos, positions)
    return mla_read(p, q_nope, q_rope, cache, cache_pos, positions, cfg, ctx), cache


def mla_verify(p, x, cache, cache_pos, cfg, ctx: Ctx, positions):
    """Multi-token absorbed decode for speculative verification: write the T
    latents at positions ``cache_pos .. cache_pos + T-1`` (contiguous, or
    through the block table; in place) and attend all T queries, query
    ``i`` masked as the decode step at its position — each query row
    reproduces that step. ``positions`` [B, T] absolute. The paged cache
    goes to K4 with T * H query rows when the backend sets
    ``fused_paged_decode``. Rejected tail entries are cleared by
    ``Model.verify_commit``."""
    q_nope, q_rope = _queries(p, x, cfg, ctx, positions)
    c_new, kr_new = _latents(p, x, cfg, ctx, positions)
    mla_write(cache, c_new, kr_new, cache_pos, positions, block=True)
    return mla_read(p, q_nope, q_rope, cache, cache_pos, positions, cfg, ctx,
                    block=True), cache


def _absorb_queries(p, q_nope, cfg, ctx: Ctx):
    """Fold W_uk into the query: q_lat [B, Sq, H, r]. Shared by the gather
    and fused paths — the same einsum, the same rounding."""
    h, dn = cfg.n_heads, cfg.qk_nope_dim
    wuk = ctx.cast(p["wuk"]["w"]).reshape(cfg.kv_lora_rank, h, dn)
    return torch.einsum("bqhd,rhd->bqhr", q_nope, wuk)


def _mla_output(p, o_lat, cfg, ctx: Ctx, b, s):
    """Up-project the latent attention output [B, Sq, H, r] through W_uv,
    then the output projection: the shared tail of both paths."""
    h, dv = cfg.n_heads, cfg.v_head_dim
    wuv = ctx.cast(p["wuv"]["w"]).reshape(cfg.kv_lora_rank, h, dv)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, wuv)
    return out_proj(p, out.reshape(b, s, -1), ctx)


def _mla_attend_paged_fused(p, q_nope, q_rope, cache, positions, cfg, ctx: Ctx,
                            backend, b, s):
    """Absorbed attention straight against the paged latent pools with K4
    (no dense gather). ``positions`` [B, T] absolute query positions."""
    from repro_torch.kernels.paged_attention import ops as paged_ops

    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    table = cache["table"]
    l_max = table.shape[1] * cache["c_kv"].shape[1]
    q_lat = _absorb_queries(p, q_nope, cfg, ctx)
    # the score shape the gather path meters
    telemetry.record_softmax(backend, (b, h, s, l_max), heads=h)
    o_lat = paged_ops.paged_attend_mla(
        q_lat, q_rope, ctx.cast(cache["c_kv"]), ctx.cast(cache["k_rope"]), table,
        positions, backend.cfg, scale=(dn + dr) ** -0.5)
    return _mla_output(p, o_lat, cfg, ctx, b, s)


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg, ctx: Ctx, b, s):
    """Absorbed attention over a contiguous latent view [B, L, r]: shared by
    the contiguous and the paged (gather) decode, so both run the same
    einsums and stay bitwise equal. ``mask`` [B?, Sq, L], broadcast over
    heads."""
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat = _absorb_queries(p, q_nope, cfg, ctx)
    c_kv = ctx.cast(c_kv)
    scores = mla_scores(q_lat, q_rope, c_kv, ctx.cast(k_rope), (dn + dr) ** -0.5)
    mask = mask[:, None, :, :].expand(scores.shape)
    backend = spec_backend(cfg.softmax)
    telemetry.record_softmax(backend, scores.shape, heads=h)
    w = backend.apply(scores, mask=mask).to(ctx.dtype)
    return _mla_output(p, mla_pv(w, c_kv), cfg, ctx, b, s)
