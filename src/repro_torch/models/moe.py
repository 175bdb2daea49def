"""Mixture-of-Experts FFN: dbrx-132b (16 experts, top-4) and
deepseek-v2-236b (160 experts, top-6, 2 shared) (port of
``src/repro/models/moe.py``: ``_moe_apply_gather``, the default
``moe_impl="gather"``, and ``_moe_apply_a2a``, ``moe_impl="a2a"``).

Token-choice top-k routing with capacity-bounded dispatch:

  router logits -> softmax -> top-k experts -> a slot per (routing group,
  expert) by a running count in token order -> tokens copied into an
  [E * C + 1, d] buffer per group (row E * C is the sentinel that takes
  every dropped assignment) -> the expert GLU as batched products over
  [E, rows, d] -> gathered back through the same targets, weighted and
  summed over the k choices.

A routing group is one batch row (one sequence) under ``"gather"``, with
C = ``capacity(cfg, S)`` slots an expert. ``"a2a"`` splits each row's S * k
assignments (token-major) into ``cfg.moe_a2a_segments`` contiguous segments
and bounds capacity per (segment, expert): C = ``segment_capacity`` slots,
counted on the segment's S * k / n assignments (no second factor of k), so
under skew it drops where ``"gather"`` would not. The expert products then
run over every segment's slots, [E, B * n * C, d]: the reference's
segment-to-expert transpose, its all-to-all across devices. Where n does
not divide S * k (a decode step, S 1; a speculative verify block, S 5;
deepseek-v2's prefill unless S % 8 == 0) the reference falls back to
``scatter_combine``, which computes the gather function, and so does the
port. The reference's a2a combine multiplies each expert row by its weight
in the compute dtype and scatter-adds it into a zeroed token row, one term
a slot; every slot is one assignment's, so its token-row value is that
product exactly, which is what the gather combine's read-back gives: the
two share the combine below (the k terms summed in f32, as ``jnp.sum``
sums bf16).

Every shape is static: a decode step (S 1) and a speculative verify block
(S 5) both get C = 4 for both models, so their expert products run at one
shape. There is no host read and no data-dependent shape, so a decode or
verify step holding this layer is captured in a CUDA graph as any other.
The tensor-parallel forward (``models/tensor_parallel.py``) passes its own
``experts`` and ``shared`` functions: the routing, dispatch and combine
here are the single-device ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Ctx, act_fn, dense_apply, mlp_apply

# moe_impl -> what the port runs. "scatter_combine" and "expert_tp" differ
# from "gather" only in how GSPMD moves data across devices: on one device
# they compute the same function (the reference's tests hold them equal),
# so they run the same code ("expert_tp" places its expert weights by
# ``mlp``: ``expert_axes``). "a2a" bounds capacity per token segment, which
# is another function.
_IMPLS = ("gather", "scatter_combine", "expert_tp", "a2a")


def moe_shapes(cfg):
    """(shape, std) of each expert leaf of one MoE layer as the reference's
    ``moe_init`` draws them (normal, std 1/sqrt(d_in)); the router [d, E]
    and the shared GLU (``n_shared_experts * d_ff_expert`` wide) are dense
    layers."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {"gate": ((e, d, f), d ** -0.5), "up": ((e, d, f), d ** -0.5),
            "down": ((e, f, d), f ** -0.5)}


def expert_axes(cfg):
    """The logical axes of each expert leaf (without the stacked layer
    axis), as the reference's ``_expert_w`` labels them: expert
    parallelism splits the expert axis; ``"expert_tp"`` splits every
    expert's hidden over ``mlp``."""
    if cfg.moe_impl == "expert_tp":
        return {"gate": (None, "embed", "mlp"), "up": (None, "embed", "mlp"),
                "down": (None, "mlp", "embed")}
    return {"gate": ("experts", "embed", "expert_mlp"),
            "up": ("experts", "embed", "expert_mlp"),
            "down": ("experts", "expert_mlp", "embed")}


def capacity(cfg, tokens_per_group: int) -> int:
    """Slots per expert and routing group: ``S * k * capacity_factor / E``,
    rounded up to a multiple of 4, at least 4."""
    c = int(tokens_per_group * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def segment_capacity(cfg, seg_assignments: int) -> int:
    """``"a2a"``'s slots per (segment, expert): ``T * capacity_factor / E``
    for a segment of T assignments, rounded up to a multiple of 4, at
    least 4."""
    c = int(seg_assignments * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def groups(cfg, s: int):
    """(G, C): the routing groups a sequence of ``s`` tokens is split into
    and the slots an expert takes in each. ``"a2a"``: its segments where
    they divide the s * k assignments; else (and for every other impl) the
    whole sequence at ``capacity``."""
    n, sk = cfg.moe_a2a_segments, s * cfg.moe_top_k
    if cfg.moe_impl == "a2a" and sk % n == 0:
        return n, segment_capacity(cfg, sk // n)
    return 1, capacity(cfg, s)


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
    """Routing of x [B, S, d], the reference's ``_route``: (C, target
    (expert * C + slot in its group, or the sentinel E * C), combine
    weights f32 (0 where dropped), aux). The S * k assignments of a row,
    token-major, split into the G groups of ``groups``, T each; slots go by
    a running count in each group. Target and weights are [B, S * k] where
    G is 1, else [B, G, T] (``"a2a"``'s segments)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    g, c = groups(cfg, s)
    logits = dense_apply(p["router"], x, ctx).to(torch.float32)      # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)                                  # [B, S, k]
    top_w = top_w / torch.clamp(_sum_k(top_w), min=1e-9)[..., None]
    flat_i = top_i.reshape(b, g, s * k // g)
    experts = torch.arange(e, device=x.device)
    onehot = (flat_i[..., None] == experts).to(torch.int32)          # [B, G, T, E]
    slot = (torch.cumsum(onehot, dim=2) - 1).gather(-1, flat_i[..., None])[..., 0]
    ok = slot < c
    target = torch.where(ok, flat_i * c + slot, torch.full_like(flat_i, e * c))
    w_flat = top_w.reshape(flat_i.shape)
    w_flat = torch.where(ok, w_flat, torch.zeros_like(w_flat))
    # GShard load-balance aux: E * mean over rows of sum_e(frac_e * mean_p_e)
    frac = (top_i[..., None] == experts).to(torch.float32).mean(dim=(1, 2))
    mean_p = probs.mean(dim=1)
    aux = e * torch.mean(torch.sum(frac * mean_p, dim=-1)) * cfg.router_aux_weight
    if g == 1:
        target, w_flat = target[:, 0], w_flat[:, 0]
    return c, target, w_flat, aux


def _experts_ffn(p, buf, cfg, ctx: Ctx):
    """The expert GLU over buf [E, R, d] (R rows an expert): act(buf @ gate)
    * (buf @ up) @ down, each a ``torch.bmm`` over E at its own R rows
    (``ctx.min_rows`` pads dense products only: a decode step and a verify
    block both run these at C = 4)."""
    gate = torch.bmm(buf, ctx.cast(p["gate"]["w"]))
    up = torch.bmm(buf, ctx.cast(p["up"]["w"]))
    return torch.bmm(act_fn(cfg.act)(gate) * up, ctx.cast(p["down"]["w"]))


def moe_apply(p, x, cfg, ctx: Ctx, experts=None, shared=None):
    """x [B, S, d] -> (y [B, S, d], aux 0-d f32). ``experts(buf)`` maps the
    dispatched rows [E, R, d] to the experts' outputs (default: the GLU of
    ``p``'s expert weights) and ``shared(x)`` gives the shared experts'
    output (default: ``p["shared"]``'s GLU where there is one)."""
    impl = cfg.moe_impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe_impl {impl!r}")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    c, target, w_flat, aux = _route(p, x, cfg, ctx)
    g = groups(cfg, s)[0]
    rows = e * c + 1                                  # + the sentinel row
    # global row of each assignment in the flattened [B * G * rows, d] buffer
    index = (target.view(b, g, -1)
             + rows * torch.arange(b * g, device=x.device).view(b, g, 1)).reshape(-1)
    buf = torch.zeros((b * g * rows, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, index, x[:, :, None].expand(b, s, k, d).reshape(-1, d))
    buf = buf.view(b * g, rows, d)[:, :e * c].reshape(b * g, e, c, d)
    buf = buf.transpose(0, 1).reshape(e, b * g * c, d)
    out = _experts_ffn(p, buf, cfg, ctx) if experts is None else experts(buf)
    out = out.reshape(e, b * g, c, d).transpose(0, 1).reshape(b * g, e * c, d)
    out = F.pad(out, (0, 0, 0, 1)).reshape(b * g * rows, d)   # sentinel row reads 0
    y_rep = out.index_select(0, index).reshape(b, s, k, d)
    terms = y_rep * w_flat.reshape(b, s, k, 1).to(y_rep.dtype)
    # the reference sums the k terms in f32 (jnp.sum upcasts bf16), then casts
    y = _sum_k(terms.to(torch.float32), dim=2).to(x.dtype)
    if shared is not None:
        y = y + shared(x)
    elif "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.act, ctx)
    return y, aux
