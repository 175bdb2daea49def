"""Cross-entropy with an ignore index and an optional z-loss (port of
``src/repro/training/loss.py``)."""

from __future__ import annotations

import torch

IGNORE = -1


def softmax_xent(logits, labels, z_loss: float = 1e-4):
    """logits [B, S, V], labels [B, S] int with ``IGNORE`` skips. The
    log-sum-exp is taken in f32, as the reference's. Returns (mean loss,
    metrics {"loss", "accuracy", "tokens"})."""
    logits = logits.to(torch.float32)
    valid = labels != IGNORE
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.long)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    n = torch.clamp(valid.sum(), min=1)
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    acc = (valid & (torch.argmax(logits, -1) == labels_safe)).sum() / n
    return loss, {"loss": loss, "accuracy": acc, "tokens": n}


def perplexity(logits, labels):
    """Eval perplexity (no z-loss)."""
    loss, _ = softmax_xent(logits, labels, z_loss=0.0)
    return torch.exp(loss)
