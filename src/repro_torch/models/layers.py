"""Common layers as plain functions on tensors (port of
``src/repro/models/layers.py``).

Parameters are nested dicts of tensors in the reference's tree layout
(``convert.params_from_numpy`` maps one onto the other). The reference keeps
f32 parameters and casts each to the compute dtype where it is used
(``ctx.cast(p["w"])``); the port stores weight matrices already in the
compute dtype, which gives the same values at every use. Norm parameters
stay f32 because the reference reads them in f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Ctx:
    dtype: torch.dtype = torch.bfloat16

    def cast(self, x):
        return x.to(self.dtype)


def dense_apply(p, x, ctx: Ctx):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_apply(p, x, kind: str, ctx: Ctx, eps: float = 1e-5):
    """rmsnorm | layernorm | layernorm_np (OLMo: non-parametric), in f32,
    cast back to the input dtype."""
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
    return p["w"][tokens]


def embed_logits(p, x, ctx: Ctx):
    """Tied read-out: x @ E^T."""
    return x @ p["w"].T


_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def mlp_apply(p, x, act: str, ctx: Ctx):
    """Gated (GLU) MLP: act(x @ gate) * (x @ up) @ down."""
    h = _ACTS[act](dense_apply(p["gate"], x, ctx)) * dense_apply(p["up"], x, ctx)
    return dense_apply(p["down"], h, ctx)


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


def positions_for(tokens_shape, device=None):
    """Default position ids of a prompt: [B, S] iota."""
    b, s = tokens_shape
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].repeat(b, 1)
