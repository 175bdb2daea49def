"""Mixture-of-Experts FFN: dbrx-132b (16 experts, top-4) and
deepseek-v2-236b (160 experts, top-6, 2 shared) (port of
``src/repro/models/moe.py``, its default ``moe_impl="gather"``,
``_moe_apply_gather``).

Token-choice top-k routing with capacity-bounded dispatch:

  router logits -> softmax -> top-k experts -> a slot per (sequence,
  expert) by a running count in token order -> tokens copied into an
  [E * C + 1, d] buffer per sequence (row E * C is the sentinel that takes
  every dropped assignment) -> the expert GLU as batched products over
  [E, B * C, d] -> gathered back through the same targets, weighted and
  summed over the k choices.

Every shape is static: the capacity C = ``capacity(cfg, S)`` is per
routing group and per call, and a routing group is one batch row (one
sequence), so in a batched prefill pad tokens take slots like any token.
An assignment past its expert's C slots drops: it targets the sentinel row
and its combine weight is 0; slots no token took compute on zeros. A
decode step (S 1) and a speculative verify block (S 5) both get C = 4 for
both models, so their expert products run at one shape. There is no host
read and no data-dependent shape, so a decode or verify step holding this
layer is captured in a CUDA graph as any other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Ctx, act_fn, dense_apply, mlp_apply

# moe_impl -> what the port runs. "scatter_combine" and "expert_tp" differ
# from "gather" only in how GSPMD moves data across devices: on one device
# they compute the same function (the reference's tests hold them equal),
# so they run the same code. "a2a" bounds capacity per token segment, which
# is another function, and is a multi-device layout.
_IMPLS = ("gather", "scatter_combine", "expert_tp")


def moe_shapes(cfg):
    """(shape, std) of each expert leaf of one MoE layer as the reference's
    ``moe_init`` draws them (normal, std 1/sqrt(d_in)); the router [d, E]
    and the shared GLU (``n_shared_experts * d_ff_expert`` wide) are dense
    layers."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {"gate": ((e, d, f), d ** -0.5), "up": ((e, d, f), d ** -0.5),
            "down": ((e, f, d), f ** -0.5)}


def capacity(cfg, tokens_per_group: int) -> int:
    """Slots per expert and routing group: ``S * k * capacity_factor / E``,
    rounded up to a multiple of 4, at least 4."""
    c = int(tokens_per_group * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def _top_k(probs, k: int):
    """The k largest probabilities and their experts, ties to the lower
    expert index (``jax.lax.top_k``'s order): a stable descending sort
    keeps equal values in index order."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def _sum_k(x, dim: int = -1):
    """Sum over the k choices on axis ``dim``, left to right: the same order
    for every token whatever the token count."""
    total = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        total = total + x.select(dim, j)
    return total


def _route(p, x, cfg, ctx: Ctx):
    """Routing of x [B, S, d]: (C, target [B, S*k] (expert * C + slot, or
    the sentinel E * C), combine weights [B, S*k] f32 (0 where dropped),
    aux). Slots go in token order over the flattened (s, k) assignments."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    c = capacity(cfg, s)
    logits = dense_apply(p["router"], x, ctx).to(torch.float32)      # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)                                  # [B, S, k]
    top_w = top_w / torch.clamp(_sum_k(top_w), min=1e-9)[..., None]
    flat_i = top_i.reshape(b, s * k)
    experts = torch.arange(e, device=x.device)
    onehot = (flat_i[..., None] == experts).to(torch.int32)          # [B, S*k, E]
    slot = (torch.cumsum(onehot, dim=1) - 1).gather(-1, flat_i[..., None])[..., 0]
    ok = slot < c
    target = torch.where(ok, flat_i * c + slot, torch.full_like(flat_i, e * c))
    w_flat = torch.where(ok, top_w.reshape(b, s * k), torch.zeros_like(top_w.reshape(b, s * k)))
    # GShard load-balance aux: E * mean over groups of sum_e(frac_e * mean_p_e)
    frac = (top_i[..., None] == experts).to(torch.float32).mean(dim=(1, 2))
    mean_p = probs.mean(dim=1)
    aux = e * torch.mean(torch.sum(frac * mean_p, dim=-1)) * cfg.router_aux_weight
    return c, target, w_flat, aux


def _experts_ffn(p, buf, cfg, ctx: Ctx):
    """The expert GLU over buf [E, R, d] (R = B * C rows an expert):
    act(buf @ gate) * (buf @ up) @ down, each a ``torch.bmm`` over E at its
    own R rows (``ctx.min_rows`` pads dense products only: a decode step
    and a verify block both run these at C = 4)."""
    gate = torch.bmm(buf, ctx.cast(p["gate"]["w"]))
    up = torch.bmm(buf, ctx.cast(p["up"]["w"]))
    return torch.bmm(act_fn(cfg.act)(gate) * up, ctx.cast(p["down"]["w"]))


def moe_apply(p, x, cfg, ctx: Ctx):
    """x [B, S, d] -> (y [B, S, d], aux 0-d f32)."""
    impl = cfg.moe_impl
    if impl == "a2a":
        raise NotImplementedError(
            "moe_impl 'a2a' (per-segment capacity, an all-to-all layout over "
            "devices) is not ported: ROADMAP.md Queue 1 item 22")
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe_impl {impl!r}")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    c, target, w_flat, aux = _route(p, x, cfg, ctx)
    rows = e * c + 1                                  # + the sentinel row
    # global row of each assignment in the flattened [B * rows, d] buffer
    index = (target + rows * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    buf = torch.zeros((b * rows, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, index, x[:, :, None].expand(b, s, k, d).reshape(-1, d))
    buf = buf.view(b, rows, d)[:, :e * c].reshape(b, e, c, d)
    out = _experts_ffn(p, buf.transpose(0, 1).reshape(e, b * c, d), cfg, ctx)
    out = out.reshape(e, b, c, d).transpose(0, 1).reshape(b, e * c, d)
    out = F.pad(out, (0, 0, 0, 1)).reshape(b * rows, d)   # sentinel row reads 0
    y_rep = out.index_select(0, index).reshape(b, s, k, d)
    terms = y_rep * w_flat.reshape(b, s, k, 1).to(y_rep.dtype)
    # the reference sums the k terms in f32 (jnp.sum upcasts bf16), then casts
    y = _sum_k(terms.to(torch.float32), dim=2).to(x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.act, ctx)
    return y, aux
