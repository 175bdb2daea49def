"""The shard-local forward of tensor-parallel serving (the device half of
``src/repro/serving/sharded.py``: the reference's ``ctx.shard`` carry
constraints under ``distributed.sharding.serving_rules``).

One process drives every shard, in shard order, and every shard is on one
device (the counterpart of XLA's simulated host devices): a mesh over
several devices needs a process per device (ROADMAP.md Queue 1 item 21)
and raises. The parameters are a ``Shards`` list of per-shard trees
(``serving.sharded.shard_params``): column-parallel weights sliced on the
model axis (q/k/v and their biases by heads and kv-heads, gate/up by
``mlp``, the MLA up-projections by heads, an untied head by ``vocab``),
the rest whole and shared. The cache is a ``Shards`` list of per-shard
caches: pools split by kv-head (MLA: by latent rank), each with its own
copy of the block table.

The residual stream is computed once, from the whole weights (embedding,
norms, ``wo``, ``down``, a tied head). Each shard runs its column-parallel
products and its attention over its own pool slice, with a config of its
share of the heads. At each of the reference's collect points the shards'
outputs are gathered in shard order (``distributed.collectives.
all_gather``) and the row-parallel product runs whole:

  * the heads before ``wo`` (the reference's ``_collect_heads``);
  * the MLP hidden before ``down``;
  * the logits of an untied head, gathered along ``vocab`` for the sampler;
  * MLA: the latent pool, gathered along the rank for the attend (each
    shard attends its heads over the whole rank, as the reference's
    ``tp_collect`` on ``c_kv``); the new latents are computed once
    (``wdkv`` and ``wkr`` are whole) and written to each shard's slice.

The MoE family (dbrx-132b, deepseek-v2-236b; the reference's expert
parallelism under ``serving_rules``, ``experts`` on the model axis) runs
each MoE layer's routing, dispatch and combine once, as
``models/moe.py`` does on one device, and splits the expert products:

  * the router runs whole: its shards' expert columns are gathered in
    shard order into the whole [d, E] weight (E columns of d: 192 KiB a
    layer for dbrx-132b in bf16) and the logits come from the
    single-device product, so routing sees the single-device bits of its
    input by construction. Logits from each shard's columns apart moved no
    routed assignment on the H100 (``chip_smoke.py`` phase 16 (g), at 2
    and 4 shards, a 512-token prefill and an 8-row decode step; PERF.md
    §6), but a product over 4 or 8 columns is another cuBLAS kernel, and
    at a near tie one moved assignment moves that token's whole output;
  * expert parallelism (``"gather"``, ``"scatter_combine"``, ``"a2a"``):
    shard i takes the dispatched rows of its contiguous block of experts
    (ceil(E / N) of them, the last block shorter where N does not divide
    E; its gate / up are its slices, or slices of the whole weights where
    the placement kept them whole, and ``down`` is row-parallel, so whole,
    and it reads its experts' rows of it) and runs their GLU over [E / N,
    R, d]; the shards' outputs are gathered in shard order along the
    expert axis and the combine runs whole. Under ``"a2a"`` R holds every
    segment's slots, [n, C_seg] an expert: a shard takes its experts'
    slots of every segment and gives them back in shard order, the
    reference's segment-to-expert all-to-all and its return;
  * ``"expert_tp"``: each shard computes its ``mlp`` columns of every
    expert's hidden, gathered along the hidden before the whole ``down``;
  * deepseek-v2's shared experts and its dense first layer run the dense
    GLU path below (gate / up by ``mlp``, the hidden gathered before
    ``down``), and MLA its latent-rank path.

No partial sums cross shards: every product is a product of the
single-device step on a slice of its columns (or of its experts). Its
logits keep the single-device bits where a slice of a product's columns
has the whole product's bits; on the card cuBLAS may pick another kernel
for the narrower slice, and a shard's K2 / K4 call plans its chunks for
its own heads, so a sharded serve there matches the single-device serve
within limits (PERF.md §6). The dense and MoE families, GQA or MLA, RoPE
or M-RoPE: the engine raises for the others.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.backends import telemetry
from repro_torch.distributed.collectives import Shards, all_gather
from repro_torch.models import kv_cache
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import (
    attn_decode, attn_prefill_tail, attn_verify, block_positions,
)
from repro_torch.models.layers import (
    act_fn, dense_apply, embed_logits, mlp_apply, norm_apply,
)
from repro_torch.models.mla import (
    _latents, _queries, mla_prefill, mla_prefill_tail, mla_read, mla_write,
)
from repro_torch.models.moe import _experts_ffn, moe_apply

ONE_DEVICE = ("tensor-parallel serving drives its shards from one process on one "
              "device; shards across devices need a process per device "
              "(ROADMAP.md Queue 1 item 21)")


class _Plan:
    """The shard count and the config of one shard's share of the heads."""

    def __init__(self, model, sp):
        cfg = model.cfg
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"the tensor-parallel forward covers the dense and MoE families (GQA or "
                f"MLA); {cfg.name} is {cfg.family}")
        if len({torch.device(d) for d in sp.devices}) != 1:
            raise NotImplementedError(f"{ONE_DEVICE}; got {[str(d) for d in sp.devices]}")
        self.n = n = len(sp)
        self.mla = cfg.attention == "mla"
        h = cfg.n_heads
        self.cfg = cfg
        self.shard_cfg = dataclasses.replace(
            cfg, n_heads=h // n, n_kv_heads=h // n if self.mla else cfg.n_kv_heads // n)
        self.rank = cfg.kv_lora_rank // n if self.mla else 0
        self.block = -(-cfg.n_experts // n)

    def latent_slice(self, c, i: int):
        """Shard ``i``'s part of the latent rank of ``c`` [..., r]."""
        return c[..., i * self.rank:(i + 1) * self.rank]

    def experts(self, i: int):
        """Shard ``i``'s experts ``lo .. hi``: contiguous blocks of
        ceil(E / N), the last shorter (or empty) where N does not divide E."""
        e = self.cfg.n_experts
        lo = min(i * self.block, e)
        return lo, min(lo + self.block, e)


def _runs(model, sp):
    """The stack's runs in layer order: (stacked key, kind, first layer in
    the cache, layers). The MoE family's dense prefix (deepseek-v2's first
    layer) runs first, as ``Model._segments``; the cache stacks every
    layer."""
    stack, runs, lo = sp[0]["stack"], [], 0
    moe = model.cfg.family == "moe"
    for key, kind in (("prefix", "dense"), ("layers", "moe" if moe else "dense")):
        if key in stack:
            n = tfm.n_stacked(stack[key])
            runs.append((key, kind, lo, n))
            lo += n
    return runs


def _layer_runs(model, sp):
    """Each layer in order: (the shards' params of it, its kind, its index
    in the cache), under ``telemetry.scan_range`` per run."""
    for key, kind, lo, n in _runs(model, sp):
        for j in telemetry.scan_range(n):
            yield [tfm.layer_params(t["stack"][key], j) for t in sp], kind, lo + j


def _without(d, key):
    return {k: v for k, v in d.items() if k != key}


def _shard_attn(plan, lp, i: int):
    """Shard ``i``'s attention params of one layer without ``wo`` (its heads'
    output is gathered first), its learned softmax parameters (ConSmax) cut
    to its heads."""
    p = _without(lp["attn"], "wo")
    if "smx" in p:
        h = plan.shard_cfg.n_heads
        p["smx"] = {k: v.narrow(-1, i * h, h) for k, v in p["smx"].items()}
    return p


def _collect_heads(outs):
    """The shards' heads [B, S, H / N * Dv] gathered in shard order before
    ``wo`` (the reference's ``_collect_heads``)."""
    return all_gather(outs, -1)


def _collect_experts(outs):
    """The shards' expert outputs [E_i, R, d] gathered in shard order along
    the expert axis before the combine (under ``"a2a"``: every segment's
    slots given back)."""
    return all_gather(outs, 0)


def _glu(ps, h, act: str, ctx):
    """A GLU (the dense FFN, or the MoE layer's shared experts) over the
    shards' params ``ps``: each its ``mlp`` columns of the hidden, gathered
    in shard order before the whole ``down``."""
    mids = [mlp_apply(_without(p, "down"), h, act, ctx) for p in ps]
    return dense_apply(ps[0]["down"], all_gather(mids, -1), ctx, ctx.step_min_rows)


def _expert_rows(w, lo: int, hi: int, e: int):
    """Experts ``lo .. hi`` of an expert weight [E or E_i, ...]: the slice
    of a whole weight (``down``, or a leaf the placement kept whole), the
    shard's own slice as it is."""
    return w[lo:hi] if w.shape[0] == e else w


def _moe(plan, lps, h, ctx):
    """One MoE layer over the shards (the module docstring): the router
    whole, the expert products split by experts (by ``mlp`` under
    ``expert_tp``), routing, dispatch and combine once."""
    cfg = plan.cfg
    e = cfg.n_experts
    ffn = [lp["ffn"] for lp in lps]
    router = ffn[0]["router"]["w"]
    if router.shape[-1] != e:
        router = all_gather([f["router"]["w"] for f in ffn], -1)

    def experts(buf):
        if cfg.moe_impl == "expert_tp":
            hid = [act_fn(cfg.act)(torch.bmm(buf, ctx.cast(f["gate"]["w"])))
                   * torch.bmm(buf, ctx.cast(f["up"]["w"])) for f in ffn]
            return torch.bmm(all_gather(hid, -1), ctx.cast(ffn[0]["down"]["w"]))
        outs = []
        for i, f in enumerate(ffn):
            lo, hi = plan.experts(i)
            mine = {k: {"w": _expert_rows(f[k]["w"], lo, hi, e)} for k in ("gate", "up", "down")}
            outs.append(_experts_ffn(mine, buf[lo:hi], cfg, ctx))
        return _collect_experts(outs)

    shared = None
    if "shared" in ffn[0]:
        def shared(x):
            return _glu([f["shared"] for f in ffn], x, cfg.act, ctx)

    return moe_apply({"router": {"w": router}}, h, cfg, ctx, experts, shared)[0]


def _block(plan, lps, x, outs, ctx, kind: str):
    """The block after its attention: x + wo(the heads gathered), then
    x + the FFN: down(the GLU hidden gathered), each shard computing its
    ``mlp`` columns of the hidden, or the MoE layer (``_moe``)."""
    cfg = plan.cfg
    x = x + dense_apply(lps[0]["attn"]["wo"], _collect_heads(outs), ctx)
    h = norm_apply(lps[0]["norm2"], x, cfg.norm, ctx)
    if kind == "moe":
        return x + _moe(plan, lps, h, ctx)
    return x + _glu([lp["ffn"] for lp in lps], h, cfg.act, ctx)


def _head(model, sp, x, ctx):
    """Final norm and logits: a tied head whole, an untied one as each
    shard's ``vocab`` columns gathered in shard order."""
    from repro_torch.models.model import _LOGIT_DTYPES

    cfg = model.cfg
    x = norm_apply(sp[0]["final_norm"], x, cfg.norm, ctx)
    if cfg.tie_embeddings:
        logits = embed_logits(sp[0]["embed"], x, ctx)
    else:
        logits = all_gather([dense_apply(t["head"], x, ctx) for t in sp], -1)
    return logits.to(_LOGIT_DTYPES[cfg.logits_dtype])


def _stack(caches):
    return kv_cache.tree_map(lambda *xs: torch.stack(xs), *caches)


def _prefill(model, sp, tokens, batch, positions, attend):
    """The prefill layers over the shards: ``attend(p, h, plan, i, l)`` gives
    shard ``i``'s heads' output and its cache of layer ``l``. Returns (last
    logits, a ``Shards`` list of the shards' caches)."""
    plan, ctx = _Plan(model, sp), model.prefill_ctx
    x = model._embed(sp[0], tokens, batch)
    caches = [[] for _ in sp]
    for lps, kind, l in _layer_runs(model, sp):
        h = norm_apply(lps[0]["norm1"], x, plan.cfg.norm, ctx)
        outs = []
        for i, lp in enumerate(lps):
            y, c = attend(_shard_attn(plan, lp, i), h, plan, i, l)
            outs.append(y)
            caches[i].append(c)
        x = _block(plan, lps, x, outs, ctx, kind)
    return _head(model, sp, x[:, -1:], model.ctx), Shards(_stack(c) for c in caches)


def prefill(model, sp, batch, cache_len: int):
    """``Model.prefill`` over the shards: (last logits, a ``Shards`` list of
    every shard's cache)."""
    tokens = batch["tokens"]
    positions = model._positions(batch, tokens)
    ctx = model.prefill_ctx

    def attend(p, h, plan, i, l):
        if not plan.mla:
            return tfm.attn_prefill(p, h, plan.shard_cfg, ctx, positions, cache_len)
        y, c = mla_prefill(p, h, plan.shard_cfg, ctx, positions, cache_len)
        return y, {"c_kv": plan.latent_slice(c["c_kv"], i), "k_rope": c["k_rope"]}

    return _prefill(model, sp, tokens, batch, positions, attend)


def prefill_tail(model, sp, batch, prefix, prefix_len: int):
    """``Model.prefill_tail`` over the shards: ``prefix`` is a ``Shards``
    list of every shard's prefix entries (``kv_cache.paged_prefix_view``);
    an MLA prefix is gathered along the rank. Returns (last logits, a
    ``Shards`` list of the tail caches)."""
    tokens = batch["tokens"]
    positions = model._positions(batch, tokens) + prefix_len
    ctx = model.prefill_ctx
    if model.cfg.attention == "mla":
        c_full = all_gather([pf["c_kv"] for pf in prefix], -1)

    def attend(p, h, plan, i, l):
        if not plan.mla:
            pf = tfm.layer_params(prefix[i], l)
            return attn_prefill_tail(p, h, pf["k"], pf["v"], plan.shard_cfg, ctx, positions,
                                     prefix_len, prefix_k_scale=pf.get("k_scale"),
                                     prefix_v_scale=pf.get("v_scale"))
        y, c = mla_prefill_tail(p, h, c_full[l], prefix[0]["k_rope"][l], plan.shard_cfg,
                                ctx, positions, prefix_len)
        return y, {"c_kv": plan.latent_slice(c["c_kv"], i), "k_rope": c["k_rope"]}

    return _prefill(model, sp, tokens, None, positions, attend)


def _step(model, sp, caches, token, cache_pos, positions, block: bool):
    """One decode step (``block`` False) or verify block over the shards;
    every shard's cache written in place. Returns the logits."""
    plan, ctx = _Plan(model, sp), model.step_ctx
    attn = attn_verify if block else attn_decode
    x = model._embed(sp[0], token)
    for lps, kind, l in _layer_runs(model, sp):
        cls = [tfm.layer_params(c, l) for c in caches]
        h = norm_apply(lps[0]["norm1"], x, plan.cfg.norm, ctx)
        if plan.mla:
            c_new, kr_new = _latents(lps[0]["attn"], h, plan.cfg, ctx, positions)
            for i, cl in enumerate(cls):
                mla_write(cl, plan.latent_slice(c_new, i), kr_new, cache_pos, positions, block)
            # the attend view: the shards' latent pools gathered along the
            # rank, beside shard 0's rope keys and table (every shard's equal)
            view = dict(cls[0], c_kv=all_gather([cl["c_kv"] for cl in cls], -1))
        outs = []
        for i, lp in enumerate(lps):
            p = _shard_attn(plan, lp, i)
            if plan.mla:
                q_nope, q_rope = _queries(p, h, plan.shard_cfg, ctx, positions)
                y = mla_read(p, q_nope, q_rope, view, cache_pos, positions, plan.shard_cfg,
                             ctx, block)
            else:
                y, _ = attn(p, h, cls[i], cache_pos, plan.shard_cfg, ctx, positions)
            outs.append(y)
        x = _block(plan, lps, x, outs, ctx, kind)
    return _head(model, sp, x, ctx)


def decode_step(model, sp, caches, batch, cache_pos, positions):
    """``Model.decode_step`` over the shards: (logits, caches)."""
    return _step(model, sp, caches, batch["token"], cache_pos, positions, False), caches


def verify_step(model, sp, caches, batch, cache_pos):
    """``Model.verify_step`` over the shards: (logits [B, T, V], the caches,
    every entry written: the dense family stages nothing else)."""
    token = batch["token"]
    b, t = token.shape
    positions = block_positions(cache_pos, b, t, token.device)
    return _step(model, sp, caches, token, cache_pos, positions, True), caches


def verify_commit(staged, n_accept, cache_pos, t: int):
    """``Model.verify_commit`` on every shard's cache: each clears its
    rejected entries."""
    for c in staged:
        kv_cache.commit_staged(c, n_accept, cache_pos, t)
    return staged
