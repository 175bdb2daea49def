"""Token samplers: functions of (logits [B, V], generator) -> int32 [B]
(port of ``src/repro/serving/sampler.py``).

Each sampler factors through a masked-logits transform, and sampling is a
Gumbel-max draw over the transformed logits (what ``jax.random.categorical``
computes). Random numbers come from an explicit ``torch.Generator`` on the
logits' device; they differ from JAX's threefry streams, so stochastic
parity is checked inside the port and greedy decoding is the
cross-framework gate. Serving samples per slot (:func:`sample_slots`): one
generator per request, consumed exactly as a batch-1 eager generation
consumes it. The same masked-logits transforms give the target
distribution of speculative verification (:func:`make_spec_verifier`):
accept a draft d with probability p(d), else resample from p with d
removed, which is distribution-identical to sampling token by token;
greedy verification is an exact prefix match.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

NEG_INF = -1e30  # large-negative mask value (finite: avoids nan in softmax)


def greedy(logits, generator=None):
    """Argmax; ties go to the lowest index, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


greedy.draws = False  # uses no random numbers: rows may be sampled together


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


# sampler name -> (sample fn, masked-logits transform); the transform is None
# for greedy alone, whose distribution is the argmax point mass (speculative
# verification special-cases it)
_SAMPLERS = {
    "greedy": (greedy, None),
    "temperature": (temperature, _temperature_logits),
    "top_p": (top_p, _top_p_logits),
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
    fn, _ = _SAMPLERS[kind]
    _validate_kwargs(kind, fn, kw)
    sampler = lambda logits, generator: fn(logits, generator, **kw)  # noqa: E731
    sampler.draws = getattr(fn, "draws", True)
    return sampler


def sample_slots(sample: Callable, logits, generators):
    """Sample one token per serving slot: logits [S, V]; ``generators`` has
    one ``torch.Generator`` per slot, or None for a slot not decoding (its
    token is 0 and ignored). A sampler that draws no random numbers (greedy)
    takes one batched call; any other is called on each live slot's [1, V]
    row with that slot's generator — the reference's vmapped per-slot PRNG
    keys — so a request consumes its generator exactly as
    ``Engine.generate(mode="eager")`` does for it alone. -> int32 [S]."""
    if not getattr(sample, "draws", True):
        return sample(logits, None)
    rows = [sample(logits[i:i + 1], g) if g is not None
            else torch.zeros((1,), dtype=torch.int32, device=logits.device)
            for i, g in enumerate(generators)]
    return torch.cat(rows)


# ------------------------------------------------------- speculative verify


def make_spec_verifier(kind="greedy", pad_id: int = 0, **kw) -> Callable:
    """The draft verifier of speculative decoding: ``verify(logits [S, T,
    V], drafts [S, K], generators) -> (out [S, T] int32, n_emit [S]
    int32)``, with T = K + 1.

    ``logits[s, j]`` is the target model's next-token distribution after
    consuming block entry ``j`` of slot ``s`` (entry 0 the last committed
    token); ``drafts[s]`` are the proposer's K guesses. ``out[s, :n_emit]``
    are the emitted tokens — the accepted draft prefix plus one final token
    (the bonus when every draft survived, else the resample at the first
    failing entry); ``out[s, n_emit:]`` is ``pad_id``.

    Greedy (``verify.draws`` False) is exact and batched on the device: a
    draft is accepted iff it equals the argmax, so the emissions equal the
    autoregressive greedy stream; ``generators`` is ignored, and it runs
    inside the captured serve step. The other samplers use
    deterministic-proposal rejection sampling against ``p =
    softmax(masked_logits)``: accept ``d_j`` with probability ``p_j(d_j)``,
    on rejection sample from ``p_j`` with ``d_j`` removed (renormalized).
    Each slot draws from its own ``torch.Generator`` (``generators[s]``;
    None for a slot not decoding, whose outputs are ``pad_id`` and 1):
    first its K uniforms, then the final token's Gumbel draw. Every
    emitted token is then an exact draw from ``p_j``; the realized tokens
    differ from the reference's threefry streams."""
    if callable(kind):
        raise ValueError("speculative verification needs a registry sampler "
                         "(its target distribution must be known); got a "
                         "callable")
    if kind not in _SAMPLERS:
        raise ValueError(f"unknown sampler {kind!r}; "
                         f"available: {available_samplers()}")
    fn, masked_fn = _SAMPLERS[kind]
    _validate_kwargs(kind, fn, kw)

    if masked_fn is None:          # greedy: exact prefix match + bonus
        def verify(logits, drafts, generators=None):
            targets = torch.argmax(logits, dim=-1).to(torch.int32)      # [S, T]
            match = (drafts.to(torch.int32) == targets[:, :-1]).to(torch.int32)
            n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
            steps = torch.arange(targets.shape[1], dtype=torch.int32,
                                 device=logits.device)
            out = torch.where(steps[None, :] <= n_acc[:, None], targets,
                              torch.full_like(targets, pad_id))
            return out, n_acc + 1

        verify.draws = False
        return verify

    def verify_one(logits, drafts, g):
        """One slot: logits [T, V], drafts [K] -> (out [T], n_emit [1])."""
        t, k = logits.shape[0], logits.shape[0] - 1
        masked = masked_fn(logits, **kw)                                # [T, V]
        probs = torch.softmax(masked, dim=-1)
        u = torch.rand((k,), generator=g, device=logits.device, dtype=torch.float32)
        p_draft = torch.gather(probs[:-1], 1, drafts[:, None].long())[:, 0]
        acc = (u < p_draft).to(torch.int32)
        n_acc = torch.cumprod(acc, dim=0).sum(dim=0, keepdim=True, dtype=torch.int32)
        # the final emission at entry n_acc: the bonus draw from the full
        # distribution when every draft survived, else the rejection
        # resample with the failed draft removed and renormalized
        last = masked.index_select(0, n_acc)                           # [1, V]
        failed = drafts.index_select(0, torch.clamp_max(n_acc, k - 1)).long()
        excl = last.scatter(1, failed[:, None], NEG_INF)
        last = torch.where((n_acc < k)[:, None], excl, last)
        emit_last = _categorical(last, g)                               # [1]
        steps = torch.arange(t, dtype=torch.int32, device=logits.device)
        drafts_pad = torch.cat([drafts.to(torch.int32), drafts[-1:].to(torch.int32)])
        out = torch.where(steps < n_acc, drafts_pad,
                          torch.where(steps == n_acc, emit_last,
                                      torch.full_like(drafts_pad, pad_id)))
        return out, n_acc + 1

    def verify(logits, drafts, generators):
        s, t = logits.shape[:2]
        outs, ns = [], []
        for i, g in enumerate(generators):
            if g is None:
                outs.append(torch.full((t,), pad_id, dtype=torch.int32, device=logits.device))
                ns.append(torch.ones((1,), dtype=torch.int32, device=logits.device))
            else:
                o, n = verify_one(logits[i], drafts[i], g)
                outs.append(o)
                ns.append(n)
        return torch.stack(outs), torch.cat(ns)

    verify.draws = True
    return verify
