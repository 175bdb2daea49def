"""Plain PyTorch version of K3, the fused prefill attention.

Port of ``src/repro/kernels/int_attention/ref.py:int_attention_ref`` with
the scores the kernel computes: the reference's oracle rounds the QK^T
einsum to the input dtype, while its Pallas kernel (and the CUDA kernel)
keep the f32-accumulated dot unrounded. So the products run in f32 on
upcast operands (exact for bf16 inputs), are scaled by d^-1/2 in f32,
masked right-aligned causal (query i at position i + Skv - Sq) with the
optional window, and go through the plain Alg. 1 (``int_softmax_block``,
the body K1-K4 reproduce); PV multiplies the probabilities rounded to v's
dtype and sums in f32, giving f32 out. GQA: head h reads kv head
h // (H / KV). The wrapper (``ops.py``) runs it for CPU tensors;
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.alg1 import int_softmax_block
from repro_torch.core.precision import PrecisionConfig


def attention_mask(sq: int, skv: int, causal: bool, window: int, device=None):
    """[Sq, Skv] bool validity (None without ``causal``): key j is valid for
    query i when j <= i + Skv - Sq and, with ``window``, i + Skv - Sq - j
    < window."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def int_attention_ref(q, k, v, cfg: PrecisionConfig, causal: bool = True,
                      window: int = 0, return_rows: bool = False):
    """q [B, H, Sq, D]; k, v [B, KV, Skv, D] (H % KV == 0), one dtype ->
    [B, H, Sq, D] float32. With ``return_rows`` also the f32 scores and
    probabilities, [B * H, Sq, Skv] each."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, d).to(torch.float32)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d ** -0.5
    mask = attention_mask(sq, skv, causal, window, device=q.device)
    probs = int_softmax_block(scores, mask, cfg)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).reshape(b, h, sq, d)
    if not return_rows:
        return out
    return out, scores.reshape(b * h, sq, skv), probs.reshape(b * h, sq, skv)
