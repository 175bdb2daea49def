"""Token samplers: functions of (logits [B, V], generator) -> int32 [B]
(port of ``src/repro/serving/sampler.py``).

Each sampler factors through a masked-logits transform, and sampling is a
Gumbel-max draw over the transformed logits (what ``jax.random.categorical``
computes). Random numbers come from an explicit ``torch.Generator`` on the
logits' device; they differ from JAX's threefry streams, so stochastic
parity is checked inside the port and greedy decoding is the
cross-framework gate. Speculative verification is a later slice (ROADMAP.md
Queue 1 item 10).
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

NEG_INF = -1e30  # large-negative mask value (finite: avoids nan in softmax)


def greedy(logits, generator=None):
    """Argmax; ties go to the lowest index, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(logits, generator):
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def _temperature_logits(logits, temp: float = 1.0, top_k: int = 0):
    """Temperature scaling + exact top-k masking: exactly ``k`` entries
    survive, ties broken by lower index (a stable descending sort)."""
    logits = logits.to(torch.float32) / max(temp, 1e-6)
    if top_k:
        k = min(top_k, logits.shape[-1])
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
        masked = torch.full_like(logits, NEG_INF)
        logits = masked.scatter(-1, idx, torch.gather(logits, -1, idx))
    return logits


def temperature(logits, generator, temp: float = 1.0, top_k: int = 0):
    return _categorical(_temperature_logits(logits, temp, top_k), generator)


def _top_p_logits(logits, p: float = 0.9, temp: float = 1.0):
    """Nucleus masking: keep exactly the smallest prefix of the
    probability-sorted vocab whose mass reaches ``p`` (the top-1 token always
    survives); ties broken by sort order."""
    logits = logits.to(torch.float32) / max(temp, 1e-6)
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p
    keep = torch.empty_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, NEG_INF)


def top_p(logits, generator, p: float = 0.9, temp: float = 1.0):
    return _categorical(_top_p_logits(logits, p, temp), generator)


_SAMPLERS = {
    "greedy": greedy,
    "temperature": temperature,
    "top_p": top_p,
}
_SAMPLERS["nucleus"] = _SAMPLERS["top_p"]


def available_samplers():
    return sorted(_SAMPLERS)


def _validate_kwargs(kind: str, fn: Callable, kw: dict) -> None:
    """Reject options the target sampler does not take — a misplaced kwarg
    (``make_sampler("greedy", top_k=8)``) must fail loudly."""
    allowed = [name for name in inspect.signature(fn).parameters
               if name not in ("logits", "generator")]
    unknown = sorted(set(kw) - set(allowed))
    if unknown:
        raise ValueError(
            f"sampler {kind!r} got unexpected options {unknown}; "
            f"it accepts {sorted(allowed)}")


def make_sampler(kind="greedy", **kw) -> Callable:
    """kind: registry name, or a callable ``(logits, generator) -> int32
    tokens``. Unknown keyword options for a registry sampler raise
    ``ValueError``."""
    if callable(kind):
        if kw:
            raise ValueError("sampler options cannot be applied to a "
                             f"callable sampler: {sorted(kw)}")
        return kind
    if kind not in _SAMPLERS:
        raise ValueError(f"unknown sampler {kind!r}; "
                         f"available: {available_samplers()}")
    fn = _SAMPLERS[kind]
    _validate_kwargs(kind, fn, kw)
    return lambda logits, generator: fn(logits, generator, **kw)
