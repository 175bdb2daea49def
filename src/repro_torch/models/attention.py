"""GQA attention with a pluggable softmax — where SoftmAP enters the model
(port of the dense paths of ``src/repro/models/attention.py``).

Plain RoPE or M-RoPE (three position streams; the masks read the temporal
one), causal, sliding-window or full masking, the Whisper decoder's
cross-attention, query-chunked prefill, tail-only
prefill against a shared prefix, single-token decode and the speculative
verify step (T tokens at once, each query masked as its own decode step)
against a contiguous or a paged cache. Paged decode and verify gather the
logical cache and attend, or — for a backend with ``fused_paged_decode`` —
run the fused paged kernel K2 (``kernels/paged_attention``). Caches are
written in place.
Under ``cfg.kv_quant`` the caches hold int8 codes with one f32 scale per
(position, head) (``kv_quantize``): prefill and tail prefill attend the
dequantized values they cache, decode dequantizes what it reads, and K2
dequantizes inside the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.backends import telemetry
from repro_torch.core.quantization import KV_RECIP_127, exaq_scale, exaq_scale_clamped
from repro_torch.core.softmax_variants import spec_backend
from repro_torch.models.layers import Ctx, apply_mrope, apply_rope, dense_apply

_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rope(x, positions, cfg):
    if cfg.rope_type == "none" or positions is None:
        return x
    if cfg.rope_type == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def mask_positions(positions, cfg):
    """The token positions the masks read: M-RoPE's temporal stream
    (``positions[0]`` of [3, B, S]), as the reference's, else ``positions``."""
    return positions[0] if cfg.rope_type == "mrope" else positions


def out_proj(p, out, ctx: Ctx):
    """The output projection ``wo`` of the heads' output [B, S, H * Dv]. A
    tensor-parallel shard's attention params hold no ``wo``: it is
    row-parallel, applied once the shards' heads are gathered
    (``models/tensor_parallel.py``, the reference's ``_collect_heads``), so
    the shard's heads come back as they are."""
    return dense_apply(p["wo"], out, ctx) if "wo" in p else out


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


def attend(q, k, v, mask, cfg, ctx: Ctx, scale=None, smx=None):
    """q [B,Sq,H,D], k [B,Skv,KV,D], v [B,Skv,KV,Dv] -> [B,Sq,H,Dv]. mask
    [B?,Sq,Skv] or None; ``scale`` defaults to D^-1/2 (MLA passes
    (dn + dr)^-1/2 with a V narrower than Q). ``smx``: the layer's learned
    softmax parameters ({"beta", "gamma"} [H] f32) when the backend is
    learnable (ConSmax); None applies the backend cfg's defaults.

    Scores round like the reference's: the einsum of compute-dtype operands
    yields the compute dtype, which is cast to ``cfg.scores_dtype`` and then
    scaled (never an f32 product of bf16 operands); the probabilities go back
    to the compute dtype before PV. Under ``ctx.per_row_scores`` the scores
    of each batch row are their own product, so a row gets the bits of a
    batch-1 call."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    group = h // kvh
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, kvh, group, dh)
    # scores: [B, KV, G, Sq, Skv]
    if ctx.per_row_scores and b > 1:
        raw = torch.cat([torch.einsum("bqkgd,bskd->bkgqs", qg[i:i + 1], k[i:i + 1])
                         for i in range(b)])
    else:
        raw = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    scores = raw.to(_SCORE_DTYPES[cfg.scores_dtype]) * scale
    backend = spec_backend(cfg.softmax)
    # one AP per attention head (KV*G of them)
    telemetry.record_softmax(backend, scores.shape, heads=kvh * group)
    m = None if mask is None else mask[:, None, None, :, :]
    if smx is not None and getattr(backend, "learnable", False):
        # head h = kv_head * group + g: the order qg unpacked above
        w = backend.apply(scores, mask=m, params={
            "beta": smx["beta"].reshape(kvh, group, 1, 1),
            "gamma": smx["gamma"].reshape(kvh, group, 1, 1)})
    else:
        w = backend.apply(scores, mask=m)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(ctx.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def attend_chunked(q, k, v, q_pos, kv_pos, kind, cfg, ctx: Ctx, scale=None, smx=None):
    """Query-chunked attention: bounds live score memory to
    [B, H, chunk, Skv]. Exact (full rows per chunk)."""
    b, sq, h, dh = q.shape
    chunk = cfg.attn_chunk
    if chunk <= 0 or sq <= chunk or sq % chunk != 0:
        return attend(q, k, v, _mask(q_pos, kv_pos, kind, cfg.window), cfg, ctx,
                      scale, smx)
    outs = []
    for i in telemetry.scan_range(sq // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        mask = _mask(q_pos[:, sl], kv_pos, kind, cfg.window)
        outs.append(attend(q[:, sl], k, v, mask, cfg, ctx, scale, smx))
    return torch.cat(outs, dim=1)


def attn_apply(p, x, cfg, ctx: Ctx, positions, kind: str = "causal"):
    """Training / prefill self-attention. kind: causal | window | none."""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, ctx, positions)
    pos = mask_positions(positions, cfg)
    out = attend_chunked(q, k, v, pos, pos, kind, cfg, ctx, smx=p.get("smx"))
    return out_proj(p, out.reshape(b, s, -1), ctx)


def attn_cross(p, x, enc_k, enc_v, cfg, ctx: Ctx):
    """Cross-attention (the Whisper decoder): queries from ``x`` [B, S, d],
    K/V [B, S_enc, KV, D] projected from the encoder output once
    (:func:`cross_kv`). Unmasked: every query row sees every frame."""
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x, ctx).reshape(b, s, cfg.n_heads, cfg.d_head)
    out = attend(q, enc_k, enc_v, None, cfg, ctx, smx=p.get("smx"))
    return out_proj(p, out.reshape(b, s, -1), ctx)


def cross_kv(p, enc_out, cfg, ctx: Ctx):
    """The cross-attention K/V of the encoder output [B, S_enc, d]."""
    b, s, _ = enc_out.shape
    k = dense_apply(p["wk"], enc_out, ctx).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = dense_apply(p["wv"], enc_out, ctx).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return k, v


def kv_quantize(x, scheme: str = "absmax"):
    """[B, S, KV, D] -> (int8 codes, f32 scale [B, S, KV]): symmetric absmax
    over the head dim, one scale per (position, head), a function of that
    position's amax alone. ``absmax``: max(amax / 127, 1e-8), the division
    as the reference's compiled graph does it (a multiplication by the f32
    reciprocal); ``exaq``: the next power of two up; ``exaq_clamped``: its
    exponent clamped to a signed 5-bit field. Codes are round-half-even of
    x / scale (a true division by a tensor), clipped to [-127, 127]."""
    xf = x.to(torch.float32)
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    if scheme == "exaq":
        scale = exaq_scale(amax)
    elif scheme == "exaq_clamped":
        scale = exaq_scale_clamped(amax, 5)
    else:
        scale = torch.clamp_min(amax * KV_RECIP_127, 1e-8)
    codes = torch.clamp(torch.round(xf / scale), -127, 127)
    return codes.to(torch.int8), scale[..., 0]


def kv_dequantize(codes, scale, dtype):
    """codes [..., D] times scale [...], one f32 product, rounded to ``dtype``."""
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def kv_fake_quant(x, scheme: str = "absmax"):
    """(codes, scale, the dequantized values in x's dtype): prefill attends
    the values it caches, so every later reader of the int8 cache sees
    exactly what the prompt rows attended."""
    codes, scale = kv_quantize(x, scheme)
    return codes, scale, kv_dequantize(codes, scale, x.dtype)


def _cache_entries(k, v, cfg, quant: bool):
    """The cache leaves of new K/V [B, T, KV, D]: as they are, or int8 codes
    with their scales."""
    if not quant:
        return {"k": k, "v": v}
    kq, ks = kv_quantize(k, cfg.kv_quant_scheme)
    vq, vs = kv_quantize(v, cfg.kv_quant_scheme)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def cache_write(buf, new, cache_pos):
    """Write ``new`` [B, T, ...] into ``buf`` [B, L, ...] at ``cache_pos``,
    IN PLACE (the reference returns a new buffer; updating the one buffer
    saves a cache copy per token). Returns ``buf``.

    ``cache_pos`` an int or a 0-d tensor: one slice shared by the whole
    batch, clamped to fit like ``lax.dynamic_update_slice`` (a tensor on
    the device, through ``index_copy_``: no host read). ``cache_pos`` a
    ``[B]`` tensor: each row lands at its own position
    (:func:`cache_write_block`); a row whose position is out of range
    writes nothing."""
    t, l_max = new.shape[1], buf.shape[1]
    if isinstance(cache_pos, int):
        start = min(max(cache_pos, 0), l_max - t)
        buf[:, start:start + t] = new.to(buf.dtype)
        return buf
    if cache_pos.ndim == 0:
        start = cache_pos.to(torch.long).clamp(0, l_max - t)
        idx = start + torch.arange(t, dtype=torch.long, device=buf.device)
        buf.index_copy_(1, idx, new.to(buf.dtype))
        return buf
    return cache_write_block(buf, new, cache_pos)


def valid_upto(l_max: int, cache_pos, window: int = 0, device=None):
    """[1 or B, l_max] validity: positions <= cache_pos (and, with
    ``window``, within the trailing window). ``cache_pos`` an int or a 0-d
    tensor (the result broadcasts over the batch) or a per-row [B]
    tensor."""
    kv_pos = torch.arange(l_max, dtype=torch.int32, device=device)[None, :]
    pos = cache_pos if isinstance(cache_pos, int) else cache_pos.reshape(-1, 1)
    valid = kv_pos <= pos
    if window:
        valid &= kv_pos > pos - window
    return valid


def paged_gather(pool, table):
    """The contiguous per-row view of a paged pool: ``pool`` [NB, BS, ...],
    ``table`` [B, n_logical] -> [B, n_logical * BS, ...]. A table entry
    outside ``[0, NB)`` (the ``NB`` sentinel, or anything stale) yields an
    all-zero block, as the reference's and K2's."""
    nb, bs = pool.shape[:2]
    b, n = table.shape
    pages = pool[table.clamp(0, nb - 1).long()]          # [B, n, BS, ...]
    dead = (table < 0) | (table >= nb)
    pages = torch.where(dead.reshape((b, n) + (1,) * (pages.ndim - 2)),
                        torch.zeros((), dtype=pool.dtype, device=pool.device),
                        pages)
    return pages.reshape((b, n * bs) + tuple(pool.shape[2:]))


def _write_target(table, cache_pos, nb: int, bs: int):
    """Where writes through ``table`` land: the flat pool row ``pb * bs +
    off`` of each entry and whether it lands, flattened over [B, T].
    ``cache_pos``: an int, a 0-d or a [B] tensor (one entry per batch row)
    or a [B, T] tensor of positions (a verify block). An entry whose
    position is past the table (a parked slot at ``cache_len``, an
    over-draft tail) or whose table entry is a sentinel does not land."""
    b, n_log = table.shape
    if isinstance(cache_pos, int):
        pos = torch.full((b, 1), cache_pos, dtype=torch.long, device=table.device)
    else:
        pos = cache_pos.to(torch.long)
        pos = pos.reshape(-1, 1).expand(b, 1) if pos.ndim < 2 else pos
    lb, off = pos // bs, pos % bs
    pb = table.gather(1, lb.clamp(0, n_log - 1)).to(torch.long)
    lands = (lb >= 0) & (lb < n_log) & (pb >= 0) & (pb < nb)
    return (pb * bs + off).reshape(-1), lands.reshape(-1)


def _put_rows(flat, target, lands, new):
    """Write ``new`` [N, ...] at rows ``target`` [N] of ``flat`` [*lead, R,
    ...] (the row axis after ``flat.ndim - new.ndim`` leading axes, over
    which ``new`` broadcasts) where ``lands``, in place. An entry that does
    not land repeats the first landing entry's write (same index, same
    value — so the duplicate is harmless), or rewrites row 0 with its own
    value when none lands: the reference's dropped writes without a
    data-dependent shape or a host sync."""
    lead = flat.ndim - new.ndim
    new = new.to(flat.dtype)
    # first landing entry, else 0 (index_select: a tensor index would sync)
    first = torch.argmax(lands.to(torch.int32), dim=0, keepdim=True)
    any_lands = lands.index_select(0, first)
    idx = torch.where(lands, target,
                      torch.where(any_lands, target.index_select(0, first), 0))
    bcast = (1,) * (new.ndim - 1)
    fill = torch.where(any_lands.reshape((1,) + bcast),
                       new.index_select(0, first), flat.narrow(lead, 0, 1))
    keep = lands.reshape((-1,) + bcast)
    flat.index_copy_(lead, idx, torch.where(keep, new, fill))
    return flat


def _put(pool, target, lands, new):
    """``_put_rows`` on a pool [NB, BS, ...] seen as its NB * BS rows."""
    nb, bs = pool.shape[:2]
    _put_rows(pool.view((nb * bs,) + tuple(pool.shape[2:])), target, lands, new)
    return pool


def _block_target(cache_pos, b: int, t: int, l_max: int, device):
    """Rows ``row * l_max + p`` of a contiguous [B, L, ...] buffer seen as
    its B * L rows, for the positions ``p = cache_pos + i`` (i < T), and
    whether each lands (``0 <= p < l_max``): [B * T] each."""
    pos = block_positions(cache_pos, b, t, device).to(torch.long)
    lands = (pos >= 0) & (pos < l_max)
    rows = torch.arange(b, dtype=torch.long, device=device)[:, None] * l_max
    return (rows + pos).reshape(-1), lands.reshape(-1)


def block_positions(cache_pos, b: int, t: int, device):
    """[B, T] int32 positions ``cache_pos + i`` (i < T) of a verify block;
    ``cache_pos`` an int, a 0-d or a [B] tensor, kept on its device."""
    steps = torch.arange(t, dtype=torch.int32, device=device)[None, :]
    if isinstance(cache_pos, int):
        return (steps + cache_pos).expand(b, t)
    return cache_pos.to(torch.int32).reshape(-1, 1).expand(b, 1) + steps


def cache_write_block(buf, new, cache_pos):
    """Write a BLOCK of T entries per batch row into ``buf`` [B, L, ...] at
    positions ``cache_pos + i`` (i < T), in place: the multi-token
    counterpart of :func:`cache_write` used by the speculative verify
    step. ``new`` [B, T, ...]; ``cache_pos`` an int, a 0-d or a [B]
    tensor. Positions past the buffer (parked slots at ``cache_len``,
    over-draft tails near the end of a request's budget) drop instead of
    writing. Returns ``buf``."""
    b, t = new.shape[:2]
    l_max = buf.shape[1]
    target, lands = _block_target(cache_pos, b, t, l_max, buf.device)
    _put_rows(buf.view((b * l_max,) + tuple(buf.shape[2:])), target, lands,
              new.reshape((b * t,) + tuple(new.shape[2:])))
    return buf


def paged_write_block(pool, table, new, cache_pos):
    """Multi-token :func:`paged_write`: scatter ``new`` [B, T, ...] through
    the block table at positions ``cache_pos + i``, in place. Entries past
    the table (sentinel entries, parked slots, over-draft tails) drop."""
    b, t = new.shape[:2]
    pos = block_positions(cache_pos, b, t, table.device)
    target, lands = _write_target(table, pos, *pool.shape[:2])
    return _put(pool, target, lands, new.reshape((b * t,) + tuple(new.shape[2:])))


def verify_mask(l_max: int, q_pos, window: int = 0):
    """[B, T, l_max] validity for a multi-token verify step: query ``i`` of
    row ``b`` sits at absolute position ``q_pos[b, i]`` and may attend every
    cache position ``<= q_pos[b, i]`` (within the trailing ``window`` when
    set) — exactly the masks T successive single-token decode steps would
    apply, so verify attention rows match the autoregressive ones."""
    kv = torch.arange(l_max, dtype=torch.int32, device=q_pos.device)[None, None, :]
    q = q_pos.to(torch.int32)[:, :, None]
    valid = kv <= q
    if window:
        valid &= kv > q - window
    return valid


def paged_write(pool, table, new, cache_pos):
    """Write one entry per batch row into ``pool`` [NB, BS, ...] at
    ``cache_pos`` (an int, a 0-d or a [B] tensor) through ``table`` [B, n_log], in
    place. Rows past the table or on a sentinel entry are dropped."""
    target, lands = _write_target(table, cache_pos, *pool.shape[:2])
    return _put(pool, target, lands, new)


def _attend_paged_fused(p, q, cache, positions, cfg, ctx: Ctx, kind, backend):
    """Attend straight against the paged pools with K2 (no dense gather).
    ``positions`` [B, T] absolute query positions."""
    from repro_torch.kernels.paged_attention import ops as paged_ops

    b, t, h, dh = q.shape
    table = cache["table"]
    kvh = cache["k"].shape[2]
    l_max = table.shape[1] * cache["k"].shape[1]
    # the score shape the gather path meters: metering does not depend on
    # the substrate
    telemetry.record_softmax(backend, (b, kvh, h // kvh, t, l_max),
                             heads=kvh * (h // kvh))
    # an int8 pool goes to K2 as codes with their scales
    quant = "k_scale" in cache
    k, v = (cache["k"], cache["v"]) if quant else (cache["k"].to(q.dtype),
                                                    cache["v"].to(q.dtype))
    out = paged_ops.paged_attend_dense(
        q, k, v, table, positions, backend.cfg, scale=dh ** -0.5,
        window=cfg.window if kind == "window" else 0,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        scores_dtype=_SCORE_DTYPES[cfg.scores_dtype])
    return out_proj(p, out.reshape(b, t, -1), ctx)


def _attn_decode_paged(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, kind):
    """Paged single-token decode: write the new K/V (an int8 pool: codes and
    scales) through the block table (in place), then attend — gathering the
    whole logical cache, or with K2 when the backend sets
    ``fused_paged_decode``."""
    b, s, _ = x.shape  # s == 1
    q, k_new, v_new = project_qkv(p, x, cfg, ctx, positions)
    table = cache["table"]
    quant = "k_scale" in cache
    target, lands = _write_target(table, cache_pos, *cache["k"].shape[:2])
    for name, val in _cache_entries(k_new, v_new, cfg, quant).items():
        _put(cache[name], target, lands, val[:, 0])
    backend = spec_backend(cfg.softmax)
    if getattr(backend, "fused_paged_decode", False):
        if isinstance(cache_pos, int):
            pos = torch.full((b, 1), cache_pos, dtype=torch.int32, device=x.device)
        else:
            pos = cache_pos.to(torch.int32).expand(b)[:, None]
        return _attend_paged_fused(p, q, cache, pos, cfg, ctx, kind,
                                   backend), cache
    k = paged_gather(cache["k"], table)
    v = paged_gather(cache["v"], table)
    if quant:
        k = kv_dequantize(k, paged_gather(cache["k_scale"], table), ctx.dtype)
        v = kv_dequantize(v, paged_gather(cache["v_scale"], table), ctx.dtype)
    l_max = k.shape[1]
    valid = valid_upto(l_max, cache_pos, cfg.window if kind == "window" else 0,
                       device=x.device)
    mask = valid[:, None, :].expand(b, 1, l_max)
    out = attend(q, ctx.cast(k), ctx.cast(v), mask, cfg, ctx, smx=p.get("smx"))
    return out_proj(p, out.reshape(b, s, -1), ctx), cache


def attn_prefill_tail(p, x, prefix_k, prefix_v, cfg, ctx: Ctx, positions,
                      prefix_len: int, prefix_k_scale=None, prefix_v_scale=None):
    """Prefill the unshared prompt tail against shared-prefix K/V.

    ``x`` embeds tokens[prefix_len:]; ``prefix_k``/``prefix_v`` [B, s, KV, D]
    hold the exact values a whole prefill cached for those positions, so the
    tail's attention rows and its own K/V equal the whole prefill's. Returns
    (y, {"k","v"} tail cache [B, T, ...]).

    Under ``cfg.kv_quant`` the prefix arrives as int8 codes with their
    scales ``prefix_*_scale`` [B, s, KV] and is dequantized; the tail is
    fake-quantized as a whole prefill would (it attends the dequantized
    values), and the tail cache holds codes and scales."""
    b, t, _ = x.shape
    q, k_t, v_t = project_qkv(p, x, cfg, ctx, positions)
    if cfg.kv_quant:
        kq, ks, k_t = kv_fake_quant(k_t, cfg.kv_quant_scheme)
        vq, vs, v_t = kv_fake_quant(v_t, cfg.kv_quant_scheme)
        pk = kv_dequantize(prefix_k, prefix_k_scale, k_t.dtype)
        pv = kv_dequantize(prefix_v, prefix_v_scale, v_t.dtype)
        tail = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        pk, pv = ctx.cast(prefix_k), ctx.cast(prefix_v)
        tail = {"k": k_t, "v": v_t}
    k = torch.cat([pk, k_t], dim=1)
    v = torch.cat([pv, v_t], dim=1)
    kv_pos = torch.arange(prefix_len + t, dtype=torch.int32,
                          device=x.device)[None, :]
    out = attend_chunked(q, k, v, positions, kv_pos, "causal", cfg, ctx, smx=p.get("smx"))
    y = out_proj(p, out.reshape(b, t, -1), ctx)
    return y, tail


def attn_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions,
                kind: str = "causal"):
    """Single-token decode against a contiguous cache {"k","v"} [B, L, KV, D]
    (int8 codes with {"k_scale","v_scale"} [B, L, KV] under ``kv_quant``)
    or a paged one ({"table"} present: pools [NB, BS, KV, D]), written in
    place. ``cache_pos``: int, 0-d or per-row [B] tensor."""
    if "table" in cache:
        return _attn_decode_paged(p, x, cache, cache_pos, cfg, ctx, positions,
                                  kind)
    b, s, _ = x.shape  # s == 1
    q, k_new, v_new = project_qkv(p, x, cfg, ctx, positions)
    quant = "k_scale" in cache
    new_cache = {name: cache_write(cache[name], val, cache_pos)
                 for name, val in _cache_entries(k_new, v_new, cfg, quant).items()}
    k, v = new_cache["k"], new_cache["v"]
    if quant:
        k = kv_dequantize(k, new_cache["k_scale"], ctx.dtype)
        v = kv_dequantize(v, new_cache["v_scale"], ctx.dtype)
    l_max = k.shape[1]
    valid = valid_upto(l_max, cache_pos, cfg.window if kind == "window" else 0,
                       device=x.device)
    mask = valid[:, None, :].expand(b, 1, l_max)
    out = attend(q, ctx.cast(k), ctx.cast(v), mask, cfg, ctx, smx=p.get("smx"))
    y = out_proj(p, out.reshape(b, s, -1), ctx)
    return y, new_cache


def attn_verify(p, x, cache, cache_pos, cfg, ctx: Ctx, positions,
                kind: str = "causal"):
    """Multi-token decode for speculative verification: write K/V for all T
    tokens at positions ``cache_pos .. cache_pos + T-1`` (in place) and
    attend the T queries in one pass, query ``i`` masked as the decode step
    at its position would mask it, so its logits — and the written entries
    — match the autoregressive stream; rejected tail entries are cleared
    afterwards by ``Model.verify_commit``. ``positions`` [B, T] are the
    absolute positions (also the rope inputs). Contiguous, int8 and paged
    (bf16 or int8) caches; a paged cache goes to K2 with the T rows when
    the backend sets ``fused_paged_decode``."""
    b, t, _ = x.shape
    q, k_new, v_new = project_qkv(p, x, cfg, ctx, positions)
    quant = "k_scale" in cache
    entries = _cache_entries(k_new, v_new, cfg, quant)
    window = cfg.window if kind == "window" else 0
    if "table" in cache:
        table = cache["table"]
        target, lands = _write_target(table, positions, *cache["k"].shape[:2])
        for name, val in entries.items():
            _put(cache[name], target, lands, val.reshape((b * t,) + tuple(val.shape[2:])))
        backend = spec_backend(cfg.softmax)
        if getattr(backend, "fused_paged_decode", False):
            return _attend_paged_fused(p, q, cache, positions.to(torch.int32), cfg, ctx,
                                       kind, backend), cache
        k = paged_gather(cache["k"], table)
        v = paged_gather(cache["v"], table)
        if quant:
            k = kv_dequantize(k, paged_gather(cache["k_scale"], table), ctx.dtype)
            v = kv_dequantize(v, paged_gather(cache["v_scale"], table), ctx.dtype)
    else:
        for name, val in entries.items():
            cache_write_block(cache[name], val, cache_pos)
        k, v = cache["k"], cache["v"]
        if quant:
            k = kv_dequantize(k, cache["k_scale"], ctx.dtype)
            v = kv_dequantize(v, cache["v_scale"], ctx.dtype)
    mask = verify_mask(k.shape[1], positions, window)
    out = attend(q, ctx.cast(k), ctx.cast(v), mask, cfg, ctx, smx=p.get("smx"))
    return out_proj(p, out.reshape(b, t, -1), ctx), cache


def _ring_write(cache, k_new, v_new, cache_pos):
    """Write one entry per batch row into the ring {"k","v": [B, W, KV, D],
    "pos": [B, W]} at slot ``cache_pos % W``, in place, and record its
    absolute position. ``cache_pos`` an int, a 0-d or a [B] tensor; every
    row's write lands (a parked slot's too: its stripe is rewritten whole
    at its next admission). No host read."""
    b, w_cap = cache["pos"].shape
    if isinstance(cache_pos, int):
        slot = cache_pos % w_cap
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = cache_pos
        return
    if cache_pos.ndim == 0:
        slot = torch.remainder(cache_pos.to(torch.long), w_cap).reshape(1)
        cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
        cache["pos"].index_copy_(1, slot, cache_pos.to(cache["pos"].dtype).reshape(1, 1)
                                 .expand(b, 1))
        return
    rows = torch.arange(b, dtype=torch.long, device=cache_pos.device) * w_cap
    idx = rows + torch.remainder(cache_pos.to(torch.long), w_cap)
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = cache[name]
        leaf.view((b * w_cap,) + tuple(leaf.shape[2:])).index_copy_(
            0, idx, new[:, 0].to(leaf.dtype))
    cache["pos"].view(b * w_cap).index_copy_(0, idx, cache_pos.to(cache["pos"].dtype))


def attn_decode_ring(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, window: int):
    """Ring-buffer decode for sliding-window layers: cache {"k","v": [B, W,
    KV, D], "pos": [B, W] int32}, written in place. The write slot is
    ``cache_pos % W`` and validity comes from the stored absolute positions,
    per row (rows at different positions wrap on their own clocks); an
    empty entry holds position -1. RoPE is applied at write time, so the
    relative geometry survives the wrap. The masked rows go through the
    model's softmax backend (K1 on the card under ``int_pallas``)."""
    b, s, _ = x.shape  # s == 1
    q, k_new, v_new = project_qkv(p, x, cfg, ctx, positions)
    _ring_write(cache, k_new, v_new, cache_pos)
    pos_buf = cache["pos"]
    pos_col = cache_pos if isinstance(cache_pos, int) else cache_pos.to(torch.int32).reshape(-1, 1)
    valid = (pos_buf >= 0) & (pos_buf <= pos_col) & (pos_buf > pos_col - window)
    mask = valid[:, None, :].expand(b, 1, pos_buf.shape[1])
    out = attend(q, ctx.cast(cache["k"]), ctx.cast(cache["v"]), mask, cfg, ctx,
                 smx=p.get("smx"))
    return out_proj(p, out.reshape(b, s, -1), ctx), cache


def attn_verify_ring(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, window: int):
    """Multi-token ring decode with a snapshot after every token (the
    speculative verify step). A ring write at position q overwrites the
    entry of position q - W, still inside the window of earlier positions,
    so a rejected draft cannot be masked away: the T tokens run through
    the single-token ring update, and ``kv_cache.commit_staged`` restores
    the snapshot at the accepted depth. The ring is stepped in place.
    ``positions`` [B, T]. Returns (y [B, T, d], staged {"k","v": [T, B, W,
    ...], "pos": [T, B, W]})."""
    t = x.shape[1]
    ys, snaps = [], {k: [] for k in cache}
    for i in telemetry.scan_range(t):
        pi = positions[:, i].contiguous()
        # contiguous, as a decode step's input (the same product layout)
        y, cache = attn_decode_ring(p, x[:, i:i + 1].contiguous(), cache, pi, cfg, ctx,
                                    pi[:, None], window)
        ys.append(y)
        for k, leaf in cache.items():
            snaps[k].append(leaf.clone())
    return torch.cat(ys, dim=1), {k: torch.stack(v) for k, v in snaps.items()}
