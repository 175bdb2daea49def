"""Common layers as plain functions on tensors (port of
``src/repro/models/layers.py``).

Parameters are nested dicts of tensors in the reference's tree layout
(``convert.params_from_numpy`` maps one onto the other). Every weight read
casts to the compute dtype where the reference casts (``ctx.cast(p["w"])``),
so a tree of f32 master weights (training) computes in the compute dtype,
and under autograd each use's cotangent comes back to f32 before the uses
are summed, as in JAX. A serving tree stores its weights already in the
compute dtype, where the cast is the tensor itself: no op, the same bits.
Norm parameters stay f32 because the reference reads them in f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Ctx:
    dtype: torch.dtype = torch.bfloat16
    # a dense product of fewer rows is zero-padded to this many (0: never):
    # ``Model.prefill_ctx``
    min_rows: int = 0
    # the same for the MLP's down projection and the norms alone:
    # ``Model.step_ctx``
    step_min_rows: int = 0
    # attention scores one batch row at a time (the encoder-decoder's
    # step: ``Model.step_ctx``)
    per_row_scores: bool = False

    def cast(self, x):
        return x.to(self.dtype)


def _rows_matmul(x, w, min_rows: int):
    """``x @ w``; a product of fewer than ``min_rows`` rows is zero-padded
    to that many and sliced back: each row gets the bits of the padded
    product's kernel whatever the row count."""
    rows = x.numel() // x.shape[-1]
    if rows >= min_rows:
        return x @ w
    padded = F.pad(x.reshape(rows, x.shape[-1]), (0, 0, 0, min_rows - rows))
    return (padded @ w)[:rows].reshape(*x.shape[:-1], -1)


def dense_apply(p, x, ctx: Ctx, min_rows: int = 0):
    """``x @ w (+ b)``, padded to ``max(ctx.min_rows, min_rows)`` rows
    (``_rows_matmul``); the bias (Qwen2-style QKV biases) added to the
    product in the compute dtype, as the reference."""
    y = _rows_matmul(x, ctx.cast(p["w"]), max(ctx.min_rows, min_rows))
    if "b" in p:
        y = y + ctx.cast(p["b"])
    return y


def _padded_rows(x, rows: int):
    """``x`` as [max(n, rows), d] (its n rows, zero rows after them)."""
    flat = x.reshape(-1, x.shape[-1])
    return F.pad(flat, (0, 0, 0, rows - flat.shape[0])) if flat.shape[0] < rows else flat


def norm_apply(p, x, kind: str, ctx: Ctx, eps: float = 1e-5):
    """rmsnorm | layernorm | layernorm_np (OLMo: non-parametric), in f32,
    cast back to the input dtype. Fewer than ``ctx.step_min_rows`` rows are
    zero-padded to that many first: the row reductions then run at one
    shape whatever the row count, so each row gets the same bits (a zero
    row normalizes to zero and is dropped)."""
    if ctx.step_min_rows:
        n = x.numel() // x.shape[-1]
        return norm_apply(p, _padded_rows(x, ctx.step_min_rows), kind,
                          Ctx(dtype=ctx.dtype), eps)[:n].reshape(x.shape)
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        y = y * p["scale"]
    elif kind in ("layernorm", "layernorm_np"):
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * p["scale"] + p["bias"]
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return y.to(x.dtype)


def embed_apply(p, tokens, ctx: Ctx):
    """The rows of ``tokens``, cast after the gather as the reference's."""
    return ctx.cast(p["w"][tokens])


def embed_logits(p, x, ctx: Ctx, min_rows: int = 0):
    """Tied read-out: x @ E^T, padded to ``min_rows`` rows (``_rows_matmul``)."""
    return _rows_matmul(x, ctx.cast(p["w"]).T, min_rows)


_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def act_fn(name: str):
    """The GLU activation by name (the reference's ``jax.nn.silu`` /
    ``jax.nn.gelu``, whose default is the tanh approximation)."""
    return _ACTS[name]


def mlp_apply(p, x, act: str, ctx: Ctx):
    """Gated (GLU) MLP: act(x @ gate) * (x @ up) @ down. A tensor-parallel
    shard's params hold no ``down`` (row-parallel: applied once the shards'
    hidden columns are gathered, ``models/tensor_parallel.py``), so its
    hidden comes back as it is."""
    h = act_fn(act)(dense_apply(p["gate"], x, ctx)) * dense_apply(p["up"], x, ctx)
    if "down" not in p:
        return h
    return dense_apply(p["down"], h, ctx, ctx.step_min_rows)


def rope_freqs(d_half: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_half, dtype=torch.float32,
                                         device=device) / d_half))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: int tensor broadcastable to [..., S].
    Computed in f32 and cast back, as the reference."""
    d_half = x.shape[-1] // 2
    freqs = rope_freqs(d_half, theta, device=x.device)           # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs          # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d_half], x[..., d_half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, theta: float, sections):
    """Multimodal RoPE (Qwen2-VL): ``positions`` [3, ..., S] holds the
    temporal, height and width streams; the D/2 frequency bands are split
    across them by ``sections`` (band i of section j turns by stream j).
    Computed in f32 and cast back, as the reference."""
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to d_head / 2 = {d_half}")
    freqs = rope_freqs(d_half, theta, device=x.device)
    angs = positions[..., None].to(torch.float32) * freqs        # [3, ..., S, D/2]
    pieces, start = [], 0
    for i, sec in enumerate(sections):
        pieces.append(angs[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(pieces, dim=-1)[..., None, :]                # [..., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d_half], x[..., d_half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_for(tokens_shape, device=None):
    """Default position ids of a prompt: [B, S] iota."""
    b, s = tokens_shape
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].repeat(b, 1)
