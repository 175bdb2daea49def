"""Plain PyTorch version of K2, in the kernel's layout.

Gather the logical cache through the block table (``paged_gather``: a
sentinel entry gives zeros), then the port's ``attend`` arithmetic with the
plain Alg. 1 (``int_softmax_block``, the body K1 and K2 reproduce): scores
are the compute-dtype product cast to ``scores_dtype`` and scaled, rows are
masked ``kpos <= qpos`` (and ``kpos > qpos - window``), probabilities go
back to the compute dtype before PV. The einsums are the ones ``attend``
runs, so on the CPU this equals the gather path of paged decode bit for
bit. The wrapper (``ops.py``) runs it for CPU and meta tensors;
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.alg1 import int_softmax_block
from repro_torch.core.precision import PrecisionConfig
from repro_torch.models.attention import paged_gather


def paged_attention_ref(q, k_pool, v_pool, table, positions,
                        cfg: PrecisionConfig, *, scale: float, window: int = 0,
                        scores_dtype=torch.float32, return_rows: bool = False):
    """q [S, KV, ROWS, D] (row ``t * group + g``), pools [NB, BS, KV, D] in
    q's dtype, table [S, NLOG] int, positions [S, T] int -> out
    [S, KV, ROWS, Dv] in q's dtype. With ``return_rows`` also the f32
    scores and probabilities, [S, KV, ROWS, NLOG * BS] each."""
    s, kvh, rows, d = q.shape
    t = positions.shape[1]
    group = rows // t
    k = paged_gather(k_pool, table)                     # [S, L, KV, D]
    v = paged_gather(v_pool, table)
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
