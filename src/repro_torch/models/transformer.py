"""Transformer blocks and the layer loops (port of
``src/repro/models/transformer.py`` for the dense, MoE, SSM, hybrid and
encoder-decoder families, GQA or MLA attention).

Layer parameters are stacked with a leading layer axis, as in the
reference; a Python loop over that axis takes the place of ``lax.scan``.
The loops iterate with ``telemetry.scan_range`` so the AP cost meter
records what the reference's trace-once scan records. Each block and loop
takes the reference's ``kind``: ``"dense"`` (the GLU MLP), ``"moe"``
(``models/moe.py``), ``"ssm"`` (``models/ssm.py``), ``"hybrid_full"`` or
``"hybrid_win"`` (``models/hybrid.py``: global or sliding-window
attention beside the SSM heads); an MoE layer's auxiliary loss is summed
by ``stack_apply`` and dropped by the serving paths, as the reference's.
The Whisper encoder is a dense stack with full (unmasked) attention
(``attn_kind="none"``); its decoder blocks (``dec_block_*``) add
cross-attention over the encoder's K/V between self-attention and the MLP.

Caches are nested dicts of tensors with the layer axis first (the
hybrid's {"attn": ..., "ssm": ...} per segment). Decode writes them in
place. A verify step writes positional leaves in place and returns the
recurrent ones (SSM state and conv tail, window rings: the nodes with a
``"state"`` or ``"pos"`` leaf) as per-token snapshots [L, T, B, ...],
which ``kv_cache.commit_staged`` resolves.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.backends import telemetry
from repro_torch.models.attention import (
    attend_chunked,
    attn_apply,
    attn_cross,
    attn_decode,
    attn_prefill_tail,
    attn_verify,
    cross_kv,
    kv_fake_quant,
    mask_positions,
    out_proj,
    project_qkv,
)
from repro_torch.models.kv_cache import tree_leaves, tree_map
from repro_torch.models.hybrid import (
    fuse_paths, hybrid_block_apply, hybrid_block_decode, hybrid_block_verify,
)
from repro_torch.models.layers import Ctx, dense_apply, mlp_apply, norm_apply
from repro_torch.models.mla import (
    mla_apply, mla_decode, mla_prefill, mla_prefill_tail, mla_verify,
)
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssm import ssm_apply, ssm_decode, ssm_verify


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


def is_recurrent(node) -> bool:
    """A cache node whose leaves are recurrent state (SSM state / conv tail,
    a window ring with its positions) rather than positional entries."""
    return isinstance(node, dict) and ("state" in node or "pos" in node)


def join_staged(cache, parts, join):
    """The staged tree of a verify step over ``cache`` from its parts (one
    per layer, or per run of layers): each recurrent node's snapshots
    joined leaf by leaf (``torch.stack`` for per-layer [T, B, ...], giving
    [L, T, B, ...]; ``torch.cat`` for runs); every positional node is the
    cache's own (written in place)."""
    if is_recurrent(cache):
        return tree_map(lambda *xs: join(xs), *parts)
    if all(not isinstance(v, dict) for v in cache.values()):
        return cache
    return {k: join_staged(v, [pt[k] for pt in parts], join) for k, v in cache.items()}


# --------------------------------------------------------------------- blocks


def _ffn(p, x, cfg, ctx: Ctx, kind: str):
    """The block's second half: x + FFN(norm2(x)), and the FFN's aux loss
    (0.0 for the dense GLU)."""
    h = norm_apply(p["norm2"], x, cfg.norm, ctx)
    if kind == "moe":
        y, aux = moe_apply(p["ffn"], h, cfg, ctx)
        return x + y, aux
    return x + mlp_apply(p["ffn"], h, cfg.act, ctx), 0.0


def _hybrid_kind(kind: str) -> str:
    return "causal" if kind == "hybrid_full" else "window"


def block_apply(p, x, cfg, ctx: Ctx, positions, kind: str = "dense",
                attn_kind: str = "causal"):
    """Pre-norm block over a whole sequence, its self-attention masked by
    ``attn_kind`` (causal, or "none": the Whisper encoder's full
    attention). Returns (x, aux)."""
    if kind == "ssm":
        return x + ssm_apply(p["ssm"], norm_apply(p["norm1"], x, cfg.norm, ctx), cfg,
                             ctx), 0.0
    if kind in ("hybrid_full", "hybrid_win"):
        return hybrid_block_apply(p, x, cfg, ctx, positions, _hybrid_kind(kind)), 0.0
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    attn = mla_apply if cfg.attention == "mla" else attn_apply
    x = x + attn(p["attn"], h, cfg, ctx, positions, attn_kind)
    return _ffn(p, x, cfg, ctx, kind)


def attn_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int, kind: str = "causal"):
    """Self-attention over the prompt (``kind`` "causal" or "window") + the
    layer's decode cache: {"k","v"} [B, cache_len, KV, D], zero past the
    prompt and in the dtype K/V were computed in (as the reference); for a
    window layer a ring {"k","v": [B, W, KV, D], "pos": [B, W]} of W =
    min(window, cache_len) slots holding the last W prompt positions at
    slot ``position % W``, -1 where empty.

    Under ``cfg.kv_quant`` the prompt of a positional layer attends the
    dequantized K/V while the cache takes their int8 codes and scales
    (fake-quant prefill), so every later reader of the cache sees what the
    prompt attended. Window rings are never quantized, as the
    reference's."""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, ctx, positions)
    positions = mask_positions(positions, cfg)
    if kind == "window":
        out = attend_chunked(q, k, v, positions, positions, "window", cfg, ctx,
                             smx=p.get("smx"))
        y = out_proj(p, out.reshape(b, s, -1), ctx)
        w_cap = min(cfg.window, cache_len)
        lo = max(0, s - w_cap)
        slots = torch.arange(lo, s, device=x.device) % w_cap
        ring = {"k": torch.zeros((b, w_cap) + tuple(k.shape[2:]), dtype=k.dtype,
                                 device=k.device),
                "v": torch.zeros((b, w_cap) + tuple(v.shape[2:]), dtype=v.dtype,
                                 device=v.device),
                "pos": torch.full((b, w_cap), -1, dtype=torch.int32, device=x.device)}
        ring["k"][:, slots] = k[:, lo:s]
        ring["v"][:, slots] = v[:, lo:s]
        ring["pos"][:, slots] = torch.arange(lo, s, dtype=torch.int32, device=x.device)
        return y, ring
    if cfg.kv_quant:
        kq, ks, k = kv_fake_quant(k, cfg.kv_quant_scheme)
        vq, vs, v = kv_fake_quant(v, cfg.kv_quant_scheme)
        leaves = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        leaves = {"k": k, "v": v}
    out = attend_chunked(q, k, v, positions, positions, "causal", cfg, ctx,
                         smx=p.get("smx"))
    y = out_proj(p, out.reshape(b, s, -1), ctx)
    cache = {}
    for name, t in leaves.items():
        buf = torch.zeros((b, cache_len) + t.shape[2:], dtype=t.dtype,
                          device=t.device)
        buf[:, :s] = t
        cache[name] = buf
    return y, cache


def block_prefill(p, x, cfg, ctx: Ctx, positions, cache_len: int,
                  kind: str = "dense"):
    """Returns (x, cache) — the decode-ready cache for this layer. A
    window layer's ring holds ``cfg.window`` slots whatever ``cache_len``,
    as the reference builds it."""
    if kind == "ssm":
        y, c = ssm_apply(p["ssm"], norm_apply(p["norm1"], x, cfg.norm, ctx), cfg, ctx,
                         return_state=True)
        return x + y, c
    if kind in ("hybrid_full", "hybrid_win"):
        ak = _hybrid_kind(kind)
        h = norm_apply(p["norm1"], x, cfg.norm, ctx)
        a, ac = attn_prefill(p["attn"], h, cfg, ctx, positions,
                             cache_len if ak == "causal" else cfg.window, ak)
        s_, sc = ssm_apply(p["ssm"], h, cfg, ctx, return_state=True)
        return fuse_paths(p, x, a, s_, cfg, ctx), {"attn": ac, "ssm": sc}
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
    if kind == "ssm":
        y, c = ssm_decode(p["ssm"], norm_apply(p["norm1"], x, cfg.norm, ctx), cache, cfg, ctx)
        return x + y, c
    if kind in ("hybrid_full", "hybrid_win"):
        return hybrid_block_decode(p, x, cache, cache_pos, cfg, ctx, positions,
                                   _hybrid_kind(kind))
    return _block_step(p, x, cache, cache_pos, cfg, ctx, positions,
                       mla_decode if cfg.attention == "mla" else attn_decode, kind)


def block_verify(p, x, cache, cache_pos, cfg, ctx: Ctx, positions, kind: str = "dense"):
    """Multi-token (draft-verify) decode step over T tokens at ``positions``
    [B, T]. Returns (x, staged): every positional entry written in place
    (the rejected tail is cleared later by ``Model.verify_commit``);
    recurrent nodes come back as per-token snapshots [T, B, ...]."""
    if kind == "ssm":
        y, c = ssm_verify(p["ssm"], norm_apply(p["norm1"], x, cfg.norm, ctx), cache, cfg, ctx)
        return x + y, c
    if kind in ("hybrid_full", "hybrid_win"):
        return hybrid_block_verify(p, x, cache, cache_pos, cfg, ctx, positions,
                                   _hybrid_kind(kind))
    return _block_step(p, x, cache, cache_pos, cfg, ctx, positions,
                       mla_verify if cfg.attention == "mla" else attn_verify, kind)


# ------------------------------------------------ encoder-decoder (Whisper)


def _dec_tail(p, x, ek, ev, cfg, ctx: Ctx):
    """A decoder block after its self-attention: cross-attention over the
    encoder's K/V, then the MLP, each pre-norm with its residual."""
    h = norm_apply(p["norm_x"], x, cfg.norm, ctx)
    x = x + attn_cross(p["cross"], h, ek, ev, cfg, ctx)
    h = norm_apply(p["norm2"], x, cfg.norm, ctx)
    return x + mlp_apply(p["mlp"], h, cfg.act, ctx)


def dec_block_apply(p, x, enc_out, cfg, ctx: Ctx, positions):
    """A decoder block over the whole sequence: causal self-attention,
    cross-attention over the encoder output ``enc_out``, the MLP."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    x = x + attn_apply(p["self"], h, cfg, ctx, positions, "causal")
    ek, ev = cross_kv(p["cross"], enc_out, cfg, ctx)
    return _dec_tail(p, x, ek, ev, cfg, ctx)


def dec_block_prefill(p, x, enc_out, cfg, ctx: Ctx, positions, cache_len: int):
    """Returns (x, {"self": the self-attention cache, "cross": {"k","v"}
    [B, S_enc, KV, D] in bf16}): the cross K/V are computed once here and
    stay in the slot's cache for every decode step, as the reference's."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    a, self_cache = attn_prefill(p["self"], h, cfg, ctx, positions, cache_len)
    ek, ev = cross_kv(p["cross"], enc_out, cfg, ctx)
    x = _dec_tail(p, x + a, ek, ev, cfg, ctx)
    return x, {"self": self_cache,
               "cross": {"k": ek.to(torch.bfloat16), "v": ev.to(torch.bfloat16)}}


def dec_block_decode(p, x, cache, cache_pos, cfg, ctx: Ctx, positions):
    """Single-token decoder step: the self cache written in place, the
    cross K/V read as they are. Returns (x, cache)."""
    h = norm_apply(p["norm1"], x, cfg.norm, ctx)
    a, _ = attn_decode(p["self"], h, cache["self"], cache_pos, cfg, ctx, positions)
    cross = cache["cross"]
    x = _dec_tail(p, x + a, ctx.cast(cross["k"]), ctx.cast(cross["v"]), cfg, ctx)
    return x, cache


# ----------------------------------------------------------------- layer loops

# the products "dots" keeps: plain matmuls (a [.., d] x [d, f] product runs
# as aten.mm), not the batched ones (the attention einsums, the experts)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _remat_contexts(policy: str):
    """(forward, recompute) contexts of a rematerialised layer: the
    recomputation in the backward records no AP cost a second time."""
    if policy == "dots":
        fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
        return fwd, _entered(rec, telemetry.repeat(0))
    return contextlib.nullcontext(), telemetry.repeat(0)


def remat(fn, policy: str, params):
    """``fn`` (one layer) rematerialised as ``cfg.remat`` says, the
    reference's ``jax.checkpoint`` of a scanned layer, while gradients are
    taken through ``params``: "full" keeps only the layer's inputs for the
    backward, "dots" also the outputs of its plain matmuls (JAX's
    ``dots_with_no_batch_dims_saveable``), "none" keeps everything.
    Without gradients (inference, serving) ``fn`` runs as it is."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    if policy == "none" or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tree_leaves(params)):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=functools.partial(_remat_contexts, policy))


def stack_apply(params, x, cfg, ctx: Ctx, positions, kind: str = "dense",
                attn_kind: str = "causal"):
    """Returns (x, the layers' summed aux loss); each layer rematerialised
    under ``cfg.remat`` while gradients are taken (:func:`remat`)."""
    block = remat(block_apply, cfg.remat, params)
    aux = 0.0
    for i in telemetry.scan_range(n_stacked(params)):
        x, a = block(layer_params(params, i), x, cfg, ctx, positions, kind, attn_kind)
        aux = aux + a
    return x, aux


def stack_prefill(params, x, cfg, ctx: Ctx, positions, cache_len: int,
                  kind: str = "dense"):
    """Returns (x, cache) with cache leaves stacked [L, B, ...]."""
    caches = []
    for i in telemetry.scan_range(n_stacked(params)):
        x, c = block_prefill(layer_params(params, i), x, cfg, ctx, positions,
                             cache_len, kind)
        caches.append(c)
    return x, tree_map(lambda *xs: torch.stack(xs), *caches)


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
    staged = []
    for i in telemetry.scan_range(n_stacked(params)):
        x, st = block(layer_params(params, i), x, layer_params(caches, i), cache_pos, cfg,
                      ctx, positions, kind)
        staged.append(st)
    return x, staged


def stack_decode(params, caches, x, cache_pos, cfg, ctx: Ctx, positions,
                 kind: str = "dense"):
    """One decode step through every layer; each layer writes its slice of
    the stacked cache (contiguous, or paged pools and table) in place, so
    the returned cache is ``caches``."""
    x, _ = _stack_step(params, caches, x, cache_pos, cfg, ctx, positions, block_decode,
                       kind)
    return x, caches


def stack_verify(params, caches, x, cache_pos, cfg, ctx: Ctx, positions,
                 kind: str = "dense"):
    """One verify step over a T-token block through every layer (the
    reference's ``scan_verify``): positional leaves written in place like
    ``stack_decode``, recurrent nodes as snapshots [L, T, B, ...]
    (``join_staged``); for a positional family the staged tree is
    ``caches``."""
    x, staged = _stack_step(params, caches, x, cache_pos, cfg, ctx, positions, block_verify,
                            kind)
    return x, join_staged(caches, staged, torch.stack)
