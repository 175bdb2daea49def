"""Transformer blocks and the layer loops (port of the dense and MoE
paths, GQA or MLA attention, of ``src/repro/models/transformer.py``).

Layer parameters are stacked with a leading layer axis, as in the
reference; a Python loop over that axis takes the place of ``lax.scan``.
The loops iterate with ``telemetry.scan_range`` so the AP cost meter
records what the reference's trace-once scan records. Each block and loop
takes the reference's ``kind``: ``"dense"`` (the GLU MLP) or ``"moe"``
(``models/moe.py``); an MoE layer's auxiliary loss is summed by
``stack_apply`` and dropped by the serving paths, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.backends import telemetry
from repro_torch.models.attention import (
    attend_chunked,
    attn_apply,
    attn_decode,
    attn_prefill_tail,
    attn_verify,
    kv_fake_quant,
    project_qkv,
)
from repro_torch.models.layers import Ctx, dense_apply, mlp_apply, norm_apply
from repro_torch.models.mla import (
    mla_apply, mla_decode, mla_prefill, mla_prefill_tail, mla_verify,
)
from repro_torch.models.moe import moe_apply


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copy."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def n_stacked(stacked) -> int:
    """Length of the leading layer axis (of the first leaf)."""
    for v in stacked.values():
        if not isinstance(v, dict):
            return v.shape[0]
        if v:
            return n_stacked(v)
    raise ValueError("parameter tree without leaves")


# --------------------------------------------------------------------- blocks


def _ffn(p, x, cfg, ctx: Ctx, kind: str):
    """The block's second half: x + FFN(norm2(x)), and the FFN's aux loss
    (0.0 for the dense GLU)."""
    h = norm_apply(p["norm2"], x, cfg.norm, ctx)
    if kind == "moe":
        y, aux = moe_apply(p["ffn"], h, cfg, ctx)
        return x + y, aux
    return x + mlp_apply(p["ffn"], h, cfg.act, ctx), 0.0


def block_apply(p, x, cfg, ctx: Ctx, positions, kind: str = "dense"):
    """Pre-norm causal block over a whole sequence. Returns (x, aux)."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    attn = mla_apply if cfg.attention == "mla" else attn_apply
    x = x + attn(p["attn"], h, cfg, ctx, positions)
    return _ffn(p, x, cfg, ctx, kind)


def attn_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int):
    """Causal self-attention over the prompt + the layer's decode cache
    {"k","v"} [B, cache_len, KV, D], zero past the prompt and in the
    dtype K/V were computed in (as the reference).

    Under ``cfg.kv_quant`` the prompt attends the dequantized K/V while the
    cache takes their int8 codes and scales (fake-quant prefill), so every
    later reader of the cache sees what the prompt attended. (The
    reference leaves the hybrid family's window rings unquantized; that
    family is not ported.)"""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, ctx, positions)
    if cfg.kv_quant:
        kq, ks, k = kv_fake_quant(k, cfg.kv_quant_scheme)
        vq, vs, v = kv_fake_quant(v, cfg.kv_quant_scheme)
        leaves = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        leaves = {"k": k, "v": v}
    out = attend_chunked(q, k, v, positions, positions, "causal", cfg, ctx,
                         smx=p.get("smx"))
    y = dense_apply(p["wo"], out.reshape(b, s, -1), ctx)
    cache = {}
    for name, t in leaves.items():
        buf = torch.zeros((b, cache_len) + t.shape[2:], dtype=t.dtype,
                          device=t.device)
        buf[:, :s] = t
        cache[name] = buf
    return y, cache


def block_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int,
                  kind: str = "dense"):
    """Returns (x, cache) — the decode-ready cache for this layer."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    prefill = mla_prefill if cfg.attention == "mla" else attn_prefill
    a, c = prefill(p["attn"], h, cfg, ctx, positions, cache_len)
    return _ffn(p, x + a, cfg, ctx, kind)[0], c


def block_prefill_tail(p, x, cfg, ctx: Ctx, positions, prefix,
                       prefix_len: int, kind: str = "dense"):
    """Prefill the unshared prompt tail of one block against the layer's
    shared-prefix entries ``prefix`` ({"k","v"} [B, s, KV, D] with
    {"k_scale","v_scale"} under ``kv_quant``, or MLA's
    {"c_kv" [B, s, r], "k_rope" [B, s, dr]}). Returns (x, tail cache) —
    entries for the tail positions only."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    if cfg.attention == "mla":
        a, c = mla_prefill_tail(p["attn"], h, prefix["c_kv"], prefix["k_rope"],
                                cfg, ctx, positions, prefix_len)
    else:
        a, c = attn_prefill_tail(p["attn"], h, prefix["k"], prefix["v"], cfg, ctx,
                                 positions, prefix_len,
                                 prefix_k_scale=prefix.get("k_scale"),
                                 prefix_v_scale=prefix.get("v_scale"))
    return _ffn(p, x + a, cfg, ctx, kind)[0], c


def _block_step(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, attn, kind):
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    a, c = attn(p["attn"], h, cache, cache_pos, cfg, ctx, positions)
    return _ffn(p, x + a, cfg, ctx, kind)[0], c


def block_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, kind: str = "dense"):
    """Single-token decode step. Returns (x, cache) — the cache updated in
    place."""
    return _block_step(p, x, cache, cache_pos, cfg, ctx, positions,
                       mla_decode if cfg.attention == "mla" else attn_decode, kind)


def block_verify(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, kind: str = "dense"):
    """Multi-token (draft-verify) decode step over T tokens at ``positions``
    [B, T]. Returns (x, cache): every token's entry written in place (the
    rejected tail is cleared later by ``Model.verify_commit``)."""
    return _block_step(p, x, cache, cache_pos, cfg, ctx, positions,
                       mla_verify if cfg.attention == "mla" else attn_verify, kind)


# ----------------------------------------------------------------- layer loops


def stack_apply(params, x, cfg, ctx: Ctx, positions, kind: str = "dense"):
    """Returns (x, the layers' summed aux loss)."""
    aux = 0.0
    for i in telemetry.scan_range(n_stacked(params)):
        x, a = block_apply(layer_params(params, i), x, cfg, ctx, positions, kind)
        aux = aux + a
    return x, aux


def stack_prefill(params, x, cfg, ctx: Ctx, positions, cache_len: int,
                  kind: str = "dense"):
    """Returns (x, cache) with cache leaves stacked [L, B, cache_len, ...]."""
    caches = []
    for i in telemetry.scan_range(n_stacked(params)):
        x, c = block_prefill(layer_params(params, i), x, cfg, ctx, positions,
                             cache_len, kind)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def stack_prefill_tail(params, prefix, x, cfg, ctx: Ctx, positions,
                       prefix_len: int, kind: str = "dense"):
    """Tail prefill through every layer; ``prefix`` leaves are stacked
    [L, B, s, ...]. Returns (x, tail cache [L, B, T, ...])."""
    caches = []
    for i in telemetry.scan_range(n_stacked(params)):
        x, c = block_prefill_tail(layer_params(params, i), x, cfg, ctx,
                                  positions, layer_params(prefix, i),
                                  prefix_len, kind)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _stack_step(params, caches, x, cache_pos, cfg, ctx: Ctx, positions, block, kind):
    for i in telemetry.scan_range(n_stacked(params)):
        x, _ = block(layer_params(params, i), x, layer_params(caches, i), cache_pos, cfg,
                     ctx, positions, kind)
    return x, caches


def stack_decode(params, caches, x, cache_pos, cfg, ctx: Ctx, positions,
                 kind: str = "dense"):
    """One decode step through every layer; each layer writes its slice of
    the stacked cache (contiguous, or paged pools and table) in place, so
    the returned cache is ``caches``."""
    return _stack_step(params, caches, x, cache_pos, cfg, ctx, positions, block_decode,
                       kind)


def stack_verify(params, caches, x, cache_pos, cfg, ctx: Ctx, positions,
                 kind: str = "dense"):
    """One verify step over a T-token block through every layer (the
    reference's ``scan_verify`` for the positional families), written in
    place like ``stack_decode``: the returned staged cache is ``caches``."""
    return _stack_step(params, caches, x, cache_pos, cfg, ctx, positions, block_verify,
                       kind)
