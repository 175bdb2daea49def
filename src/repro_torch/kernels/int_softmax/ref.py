"""Plain PyTorch version of K1, in the kernel's ``[rows, cols]`` layout.

Alg. 1 with the bit-serial division (``core.alg1.int_softmax_block``) — the
body the reference's Pallas kernel computes and the CUDA kernel reproduces
bit for bit. The wrapper (``ops.py``) runs it for CPU tensors; the chip
smoke test holds the kernel against it on the card."""

from __future__ import annotations

import torch

from repro_torch.core.alg1 import int_softmax_block
from repro_torch.core.precision import PrecisionConfig


def int_softmax_ref(x, cfg: PrecisionConfig, mask=None):
    """x: [rows, cols] float scores; mask: [rows, cols] (nonzero = valid) or
    None -> [rows, cols] float32 probabilities."""
    if x.ndim != 2:
        raise ValueError(f"expected [rows, cols] scores, got {tuple(x.shape)}")
    m = None if mask is None else mask != 0
    return int_softmax_block(x, m, cfg).to(torch.float32)
