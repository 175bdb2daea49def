"""Plain PyTorch versions of K2 and K4, in the kernels' layouts.

K2: gather the logical cache through the block table (``paged_gather``: a
sentinel entry gives zeros; an int8 pool is dequantized with its gathered
scales, ``kv_dequantize``), then the port's ``attend`` arithmetic with the
plain Alg. 1 (``int_softmax_block``, the body K1, K2 and K4 reproduce):
scores are the compute-dtype product cast to ``scores_dtype`` and scaled,
rows are masked ``kpos <= qpos`` (and ``kpos > qpos - window``),
probabilities go back to the compute dtype before PV. The einsums are the
ones ``attend`` runs, so on the CPU this equals the gather path of paged
decode bit for bit; K4's plain version likewise runs the einsums of MLA's
gather path. The wrappers (``ops.py``) run them for CPU and meta tensors;
``chip_smoke.py`` holds the kernels against them on the card.

K2 and K4 split each row over CTAs in exact Alg.-1 passes
(``csrc/paged_attention.cu``, ``csrc/paged_attention_mla.cu``). Their
partition lives here as pure functions — ``k2_span`` (the pages holding
some row's valid position), ``k2_split_plan`` and ``k4_split_plan`` (pages
per chunk, planned for the decode step's rows: a verify block of T queries
per slot is cut at the page boundaries of T single-query steps, so each of
its rows gets the bits the decode step at its position gets),
``k2_row_group`` (the rows of a chunk one K2 CTA takes) and ``k2_chunks`` —
and ``paged_attention_ref(...,
chunk_pages=p)`` and ``paged_attention_mla_ref(..., chunk_pages=p)`` mirror
it: per-chunk row maxima combined into the row max (``split_row_max``),
per-chunk exact integer sums, per-chunk f32 PV partials added in chunk
order (``combine_partials``). ``chunk_pages=None`` is the whole-row path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.alg1 import fixedpoint_div, int_exp_codes, int_softmax_block
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quantization import NEG_INF, dequantize_probs, quantize_against
from repro_torch.kernels.int_softmax.ref import split_row_max
from repro_torch.models.attention import kv_dequantize, paged_gather


# ------------------------------------------------------------- K2's partition

# Chunks hold at least this many keys (one cp.async stage of the kernel),
# their f32 score tile (rows x chunk keys) at most K2_TILE_BYTES of shared
# memory, and they grow while the grid keeps K2_CTAS_PER_SM CTAs per SM.
K2_STAGE_KEYS = 64
K2_TILE_BYTES = 48 * 1024
K2_CTAS_PER_SM = 3.5


def k2_span(positions_row, nlog: int, bs: int, window: int = 0):
    """Pages ``[lo, hi)`` of one slot that hold some row's valid position:
    from the page of ``min(qpos) - window + 1`` (page 0 without a window) to
    the page of ``max(qpos)``, within the table. A key outside it is masked
    for every row of the slot."""
    qmax, qmin = max(positions_row), min(positions_row)
    hi = 0 if qmax < 0 else min(nlog, qmax // bs + 1)
    lo = min(max(0, qmin - window + 1) // bs, hi) if window else 0
    return lo, hi


def k2_split_plan(slots: int, kv: int, rows: int, nlog: int, bs: int, sms: int,
                  t: int = 1) -> int:
    """Pages per chunk of K2's split (one CTA per chunk, kv-head and slot):
    the smallest power of two holding ``K2_STAGE_KEYS`` keys, doubled while
    the grid still has ``K2_CTAS_PER_SM`` CTAs per SM, the chunk stays
    within the table and the score tile within ``K2_TILE_BYTES``; at least
    one page. Planned for the decode step's ``rows // t`` rows (``t``: query
    positions per slot), whatever ``t`` is: the chunk boundaries, and with
    them each row's partial sums, are the decode step's."""
    rows = rows // t
    p = 1
    while p * bs < K2_STAGE_KEYS and p < nlog:
        p *= 2
    while (2 * p <= nlog and 4 * rows * 2 * p * bs <= K2_TILE_BYTES
           and slots * kv * math.ceil(nlog / (2 * p)) >= K2_CTAS_PER_SM * sms):
        p *= 2
    while p > 1 and 4 * rows * p * bs > K2_TILE_BYTES:
        p //= 2
    return p


def k2_row_group(rows: int, chunk_pages: int, bs: int) -> int:
    """Rows of a chunk one K2 CTA takes: all ``rows`` while their f32 score
    tile fits ``K2_TILE_BYTES``, else as many as fit (at least one). A
    verify block of T queries may exceed the tile its decode-step plan was
    sized for; its rows then go in groups under the same chunk, which is
    never shrunk. Rows never interact, so a group changes no bit."""
    return max(1, min(rows, K2_TILE_BYTES // (4 * chunk_pages * bs)))


# K4's partition. A head tile holds up to K4_TILE_ROWS rows of a slot (the
# kernel's four m16 tiles). Chunks hold at least K4_STAGE_KEYS keys (one
# bf16 stage of the kernel) and grow while the grid of launch 1 keeps
# K4_CTAS_PER_SM CTAs per SM; a slot has at most K4_MAX_CHUNKS of them,
# since the last CTA of a (slot, head tile, column group) reads every
# chunk's partial, 64 latent columns of each row.
K4_TILE_ROWS = 64
K4_STAGE_KEYS = 32
K4_CTAS_PER_SM = 1
K4_MAX_CHUNKS = 128


def k4_split_plan(slots: int, rows: int, nlog: int, bs: int, sms: int,
                  t: int = 1) -> int:
    """Pages per chunk of K4's split (one CTA of launch 1 per chunk, head
    tile and slot): the smallest power of two holding ``K4_STAGE_KEYS``
    keys, doubled while the chunk stays within the table and the grid still
    has ``K4_CTAS_PER_SM`` CTAs per SM, then while the table has more than
    ``K4_MAX_CHUNKS`` chunks; at least one page. Planned, as K2's, for the
    decode step's ``rows // t`` rows (the heads)."""
    tiles = math.ceil(rows // t / K4_TILE_ROWS)
    p = 1
    while p * bs < K4_STAGE_KEYS and p < nlog:
        p *= 2
    while 2 * p <= nlog and slots * tiles * math.ceil(nlog / (2 * p)) >= K4_CTAS_PER_SM * sms:
        p *= 2
    while math.ceil(nlog / p) > K4_MAX_CHUNKS:
        p *= 2
    return p


def k2_chunks(lo: int, hi: int, chunk_pages: int):
    """The chunks ``[(first page, end page), ...]`` of a span, in order."""
    return [(p, min(p + chunk_pages, hi)) for p in range(lo, hi, chunk_pages)]


def combine_partials(partials):
    """[NC, ...] f32 chunk partials -> their f32 sum, added in chunk order
    from 0 (the kernel's combine)."""
    acc = torch.zeros_like(partials[0])
    for part in partials:
        acc = acc + part
    return acc


def _split_rows(scores, valid, v, positions, cfg: PrecisionConfig, *, bs, window,
                chunk_pages, dtype):
    """Alg. 1 and PV over K2's chunks. scores [S, KV, G, T, L] (f32-exact),
    valid [S, T, L], v [S, L, KV, Dv] in ``dtype`` -> probabilities [S, KV,
    G, T, L] f32 and out [S, KV, G, T, Dv] in ``dtype``."""
    s_, kvh, g, t, l_full = scores.shape
    x = scores.to(torch.float32)
    probs = torch.zeros_like(x)
    out = torch.zeros((s_, kvh, g, t, v.shape[-1]), dtype=torch.float32, device=x.device)
    for s in range(s_):
        lo, hi = k2_span(positions[s].tolist(), l_full // bs, bs, window)
        keys = [(a * bs, b * bs) for a, b in k2_chunks(lo, hi, chunk_pages)]
        if not keys:
            continue
        xs, vm = x[s], valid[s][None, None]                 # [KV, G, T, L], [1, 1, T, L]
        cmax = torch.stack([torch.where(vm[..., a:b], xs[..., a:b], NEG_INF).amax(-1)
                            for a, b in keys], -1)          # [KV, G, T, NC]
        mrow = split_row_max(cmax)
        codes, sums = [], []
        for c, (a, b) in enumerate(keys):
            m = mrow[..., c:c + 1]
            mu = torch.where(m <= NEG_INF, 0.0, m)
            vmax = quantize_against(m, mu, cfg)               # 0 unless fully masked
            va = int_exp_codes(quantize_against(xs[..., a:b], mu, cfg) - vmax, cfg)
            va = torch.where(vm[..., a:b], va, 0)
            codes.append(va)
            sums.append(va.sum(-1, dtype=torch.int64))
        total = torch.stack(sums, -1).sum(-1).clamp(1, cfg.sum_saturation)[..., None]
        partials = []
        for c, (a, b) in enumerate(keys):
            p = dequantize_probs(fixedpoint_div(codes[c], total, cfg.P_out), cfg)
            probs[s, ..., a:b] = p
            partials.append(torch.einsum("kgtl,lkd->kgtd", p.to(dtype).to(torch.float32),
                                         v[s, a:b].to(torch.float32)))
        out[s] = combine_partials(torch.stack(partials))
    return probs, out.to(dtype)


def paged_attention_ref(q, k_pool, v_pool, table, positions,
                        cfg: PrecisionConfig, *, scale: float, window: int = 0,
                        k_scale=None, v_scale=None, scores_dtype=torch.float32,
                        chunk_pages=None, return_rows: bool = False):
    """q [S, KV, ROWS, D] (row ``t * group + g``), pools [NB, BS, KV, D] in
    q's dtype — or int8 codes with ``k_scale``/``v_scale`` [NB, BS, KV] f32
    — table [S, NLOG] int, positions [S, T] int -> out [S, KV, ROWS, Dv] in
    q's dtype. With ``return_rows`` also the f32 scores and probabilities,
    [S, KV, ROWS, NLOG * BS] each. ``chunk_pages``: None for whole rows, or
    K2's partition (``k2_chunks``), whose probabilities equal the whole
    rows' bit for bit."""
    s, kvh, rows, d = q.shape
    t = positions.shape[1]
    group = rows // t
    k = paged_gather(k_pool, table)                     # [S, L, KV, D]
    v = paged_gather(v_pool, table)
    if k_scale is not None:
        k = kv_dequantize(k, paged_gather(k_scale, table), q.dtype)
        v = kv_dequantize(v, paged_gather(v_scale, table), q.dtype)
    l_full = k.shape[1]
    qg = q.reshape(s, kvh, t, group, d).permute(0, 2, 1, 3, 4).contiguous()
    # [S, KV, G, T, L], as attend computes them
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(scores_dtype) * scale
    kpos = torch.arange(l_full, dtype=torch.int32, device=q.device)
    qpos = positions.to(torch.int32)[:, :, None]
    valid = kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    if chunk_pages is None:
        probs = int_softmax_block(scores, valid[:, None, None], cfg)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype), v)
        out = out.permute(0, 2, 1, 3, 4).reshape(s, kvh, rows, v.shape[-1])
    else:
        bs = k_pool.shape[1]
        probs, out = _split_rows(scores, valid, v, positions, cfg, bs=bs, window=window,
                                 chunk_pages=chunk_pages, dtype=q.dtype)
        out = out.permute(0, 1, 3, 2, 4).reshape(s, kvh, rows, v.shape[-1])
    if not return_rows:
        return out

    def rows_of(x):                                     # -> [S, KV, ROWS, L]
        return x.permute(0, 1, 3, 2, 4).reshape(s, kvh, rows, l_full)

    return out, rows_of(scores.to(torch.float32)), rows_of(probs)


def mla_scores(q_lat, q_rope, c_kv, k_rope, scale: float):
    """[B, H, Sq, L] f32 scores of the absorbed queries q_lat [B, Sq, H, r],
    q_rope [B, Sq, H, dr] against c_kv [B, L, r], k_rope [B, L, dr]: each
    product in the compute dtype, the sum in f32, then the scale."""
    s1 = torch.einsum("bqhr,blr->bhql", q_lat, c_kv)
    s2 = torch.einsum("bqhd,bld->bhql", q_rope, k_rope)
    return (s1.to(torch.float32) + s2.to(torch.float32)) * scale


def mla_pv(w, c_kv):
    """o_lat [B, Sq, H, r] from compute-dtype probabilities w [B, H, Sq, L]."""
    return torch.einsum("bhql,blr->bqhr", w, c_kv)


def paged_attention_mla_ref(q_lat, q_rope, c_pool, kr_pool, table, positions,
                            cfg: PrecisionConfig, *, scale: float, chunk_pages=None,
                            return_rows: bool = False):
    """Plain K4. q_lat [S, ROWS, R], q_rope [S, ROWS, DR] (row ``t * H +
    h``), pools c [NB, BS, R] and kr [NB, BS, DR] in q's dtype, table [S,
    NLOG] int, positions [S, T] int -> o_lat [S, ROWS, R] in q's dtype.

    Gather (a sentinel entry gives a zero page), then the einsums of the
    model's gather path (``mla_scores`` and ``mla_pv`` below): each
    product rounded to the compute dtype, the two added in f32, times
    ``scale``; rows masked ``kpos <= qpos``; the plain Alg. 1; PV over the
    compute-dtype probabilities. So on the CPU it equals the gather path of
    paged MLA decode bit for bit. ``chunk_pages``: None for whole rows, or
    K4's partition (``k2_chunks`` of the span), whose probabilities equal
    the whole rows' bit for bit. With ``return_rows`` also the f32 scores
    and probabilities, [S, ROWS, NLOG * BS] each."""
    s, rows, r = q_lat.shape
    t = positions.shape[1]
    h = rows // t
    c = paged_gather(c_pool, table)                     # [S, L, R]
    kr = paged_gather(kr_pool, table)                   # [S, L, DR]
    l_full = c.shape[1]
    scores = mla_scores(q_lat.reshape(s, t, h, r), q_rope.reshape(s, t, h, -1), c, kr,
                        scale)                          # [S, H, T, L]
    kpos = torch.arange(l_full, dtype=torch.int32, device=q_lat.device)
    valid = kpos <= positions.to(torch.int32)[:, :, None]
    if chunk_pages is None:
        probs = int_softmax_block(scores, valid[:, None], cfg)
        out = mla_pv(probs.to(q_lat.dtype), c).reshape(s, rows, r)
    else:
        # K2's split with one kv head whose group is the H heads
        probs, out = _split_rows(scores[:, None], valid, c[:, :, None], positions, cfg,
                                 bs=c_pool.shape[1], window=0, chunk_pages=chunk_pages,
                                 dtype=q_lat.dtype)
        probs = probs[:, 0]                             # [S, H, T, L]
        out = out[:, 0].permute(0, 2, 1, 3).reshape(s, rows, r)
    if not return_rows:
        return out

    def rows_of(x):                                     # -> [S, ROWS, L]
        return x.permute(0, 2, 1, 3).reshape(s, rows, l_full)

    return out, rows_of(scores), rows_of(probs)
