"""bf16 gradient compression with error feedback (port of
``src/repro/training/grad_compression.py``).

The reference compresses the payload of the data-parallel all-reduce to
bf16 and carries the f32 residual of the cast into the next step. On one
card no all-reduce follows (as on the reference's one-host mesh): the step
compresses and decompresses, and the residual carries over all the same.
"""

from __future__ import annotations

import torch

from repro_torch.models.kv_cache import tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress(grads, error_fb):
    """f32 grads + residual -> (bf16 payload, new f32 residual), so that
    ``payload.float() + new residual == grads + residual`` exactly."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error_fb)
    payload = tree_map(lambda c: c.to(torch.bfloat16), corrected)
    new_e = tree_map(lambda c, q: c - q.to(torch.float32), corrected, payload)
    return payload, new_e


def decompress(payload):
    return tree_map(lambda q: q.to(torch.float32), payload)
