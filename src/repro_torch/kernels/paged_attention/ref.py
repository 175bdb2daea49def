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
"""

from __future__ import annotations

import torch

from repro_torch.core.alg1 import int_softmax_block
from repro_torch.core.precision import PrecisionConfig
from repro_torch.models.attention import kv_dequantize, paged_gather


def paged_attention_ref(q, k_pool, v_pool, table, positions,
                        cfg: PrecisionConfig, *, scale: float, window: int = 0,
                        k_scale=None, v_scale=None, scores_dtype=torch.float32,
                        return_rows: bool = False):
    """q [S, KV, ROWS, D] (row ``t * group + g``), pools [NB, BS, KV, D] in
    q's dtype — or int8 codes with ``k_scale``/``v_scale`` [NB, BS, KV] f32
    — table [S, NLOG] int, positions [S, T] int -> out [S, KV, ROWS, Dv] in
    q's dtype. With ``return_rows`` also the f32 scores and probabilities,
    [S, KV, ROWS, NLOG * BS] each."""
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
    probs = int_softmax_block(scores, valid[:, None, None], cfg)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype), v)
    out = out.permute(0, 2, 1, 3, 4).reshape(s, kvh, rows, v.shape[-1])
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
                            cfg: PrecisionConfig, *, scale: float,
                            return_rows: bool = False):
    """Plain K4. q_lat [S, ROWS, R], q_rope [S, ROWS, DR] (row ``t * H +
    h``), pools c [NB, BS, R] and kr [NB, BS, DR] in q's dtype, table [S,
    NLOG] int, positions [S, T] int -> o_lat [S, ROWS, R] in q's dtype.

    Gather (a sentinel entry gives a zero page), then the einsums of the
    model's gather path (``mla_scores`` and ``mla_pv`` below): each
    product rounded to the compute dtype, the two added in f32, times
    ``scale``; rows masked ``kpos <= qpos``; the plain Alg. 1; PV over the
    compute-dtype probabilities. So on the CPU it equals the gather path of
    paged MLA decode bit for bit. With ``return_rows`` also the f32 scores
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
    probs = int_softmax_block(scores, valid[:, None], cfg)
    out = mla_pv(probs.to(q_lat.dtype), c).reshape(s, rows, r)
    if not return_rows:
        return out

    def rows_of(x):                                     # -> [S, ROWS, L]
        return x.permute(0, 2, 1, 3).reshape(s, rows, l_full)

    return out, rows_of(scores), rows_of(probs)
