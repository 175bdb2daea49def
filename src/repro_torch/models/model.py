"""Model facade for the dense, MoE, SSM, hybrid and encoder-decoder
families, GQA or MLA attention, plain RoPE or M-RoPE (port of
``src/repro/models/model.py``).

  init(generator)                          -> params (nested dict of tensors)
  train_logits(params, batch)              -> (logits [B, S, V], aux)
  prefill(params, batch, cache_len)        -> (last_logits [B, 1, V], cache)
  prefill_tail(params, batch, prefix, s)   -> (last_logits [B, 1, V], tail cache)
  decode_step(params, cache, batch, pos)   -> (logits [B, 1, V], cache)
  verify_step(params, cache, batch, pos)   -> (logits [B, T, V], staged cache)
  verify_commit(staged, n_accept, pos, T)  -> cache (rejected tail cleared)

Batches hold int token tensors on the model's device: {"tokens": [B, S]}
for prefill, {"token": [B, 1]} for a decode step, {"token": [B, T]} for a
verify step. An M-RoPE model (qwen2-vl-7b) also takes "positions" [3, B,
S] (t / h / w streams; [3, B, 1] in a decode step) and may take the VLM
stub's "embeds_override" [B, S, d] with "override_mask" [B, S]; the
encoder-decoder (whisper-base) takes "frames" [B, S_enc, d] beside its
decoder tokens (the stub frontend's output). The cache is updated in
place. Under ``cfg.kv_quant`` the GQA caches hold int8 codes and f32
scales (MLA keeps its bf16 latent cache, as the reference).

The MoE family's stack is ``{"layers": the MoE layers, "prefix": the
cfg.n_dense_prefix dense layers}`` (deepseek-v2-236b has one), as the
reference's: every entry point runs the prefix, then the MoE layers, over
one cache whose layer axis holds the prefix's layers first. The SSM
family's is ``{"layers"}`` of SSD blocks, its cache {"state", "conv"}
([L, B, ...]); the hybrid's is ``{"full": the 3 global layers, "win_a",
"win_b": the window layers between them}``, run in the order full[0],
win_a, full[1], win_b, full[2], with one cache segment per stack segment
({"attn": positional or ring, "ssm": ...}). Their verify step stages the
recurrent state as per-token snapshots, which ``verify_commit`` resolves
into the cache. The encoder-decoder keeps ``pos_embed`` (the decoder's
learned position table), ``enc_stack`` (dense blocks, full attention,
after a sinusoid table added to the frames), ``enc_final_norm`` and
``dec_stack`` ({"norm1", "self", "norm_x", "cross", "norm2", "mlp"}); its
cache is {"self", "cross"}, the cross K/V computed once in prefill. As in
the reference, neither the encoder-decoder nor M-RoPE has a tail prefill
or a verify step: both raise.

Tensor-parallel serving passes a ``Shards`` list of per-shard parameter
trees (``serving.sharded.shard_params``) and per-shard caches: prefill,
tail prefill, decode and verify then run the shard-local forward of
``models/tensor_parallel.py`` (the dense and MoE families). ``param_axes``
gives the reference's logical axes of every parameter, which that placement
reads (the expert leaves' per ``moe_impl``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.backends import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.softmax_variants import spec_backend
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import Shards
from repro_torch.models import kv_cache
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import block_positions
from repro_torch.models.layers import (
    Ctx, dense_apply, embed_apply, embed_logits, norm_apply, positions_for,
)
from repro_torch.models.mla import mla_dense_shapes
from repro_torch.models.moe import expert_axes, moe_shapes

_LOGIT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Prefill products on the card take at least this many rows, zero-padded.
# cuBLAS picks a split-K kernel for a product of 128 rows or fewer over a
# long inner dimension (olmo-1b's and llama2-7b's down projections), which
# sums in another order, so a prompt committed in chunk pieces would get
# other K/V than the whole prompt; from 200 rows up each row comes out with
# the same bits whatever the row count (probes/prefill_rows.py).
PREFILL_MIN_ROWS = 256
# The down projection and the norms of a decode step and of a speculative
# verify block take at least this many rows on the card, zero-padded, so a
# verified token gets the bits the plain decode step gives it. At a verify
# block's 40 rows olmo-1b's down projection splits its sum in another order
# than at the decode step's 8 (cuBLAS's split-K; probes/verify_rows.py).
# Padding it alone left served rows apart on the card, and padding the
# norms too made them bitwise (chip_smoke.py phase 14; probes/verify_step.py
# compares the step op by op and graphed). 64 is the cheapest count the
# probe shows bitwise for phase 14's blocks (8 slots x 5 tokens): a block of
# more rows keeps its own. The dense family's other products keep their
# rows. An MoE model's step pads every dense product to 64 rows: with the
# dense family's padding alone, the verify blocks of dbrx-132b and
# deepseek-v2-236b left the decode step's bits at an early projection, and
# with every dense product padded each op of their steps was bitwise, op
# by op and graphed (probes/verify_step.py --arch <moe> --layers 4,
# PERF.md). The expert products (``moe._experts_ffn``) take no padding: a
# decode step and a verify block both route C = 4 slots an expert, so
# they run at one shape ([E, 32, d] at 8 slots). Nor do they in prefill,
# where C follows the call's length (MoE chunking is not run on the card).
# The hybrid family (hymba-1.5b) pads its LM head as well: its verify
# block runs the SSM heads and the window layers' ring attention one token
# at a time, at the decode step's rows (contiguous inputs, so each product
# sees the decode step's layout), and with the dense family's padding
# every op of its block gave the decode steps' bits but the head ([40,
# 1600] x [1600, 32001] against [8, 1600] x ...). With the head padded
# too every op is bitwise, op by op and graphed, and a replayed step costs
# 0.60 ms less than with every dense product padded (14.86 against 15.46
# ms a decode step, 61.57 against 63.75 a verify block; probes/
# verify_step.py --arch hymba-1.5b, PERF.md). The SSM family (mamba2-780m)
# needs nothing beyond the dense family's rule: its verify runs every
# product per token at the decode step's rows, and its head gave the
# decode steps' bits. The M-RoPE step pads as the dense family's. The
# encoder-decoder's serve step must give each slot the bits of the
# request's batch-1 eager step (the reference's gate, held bitwise on the
# card by chip_smoke.py phase 18): it pads as the dense family's and its
# head too (the tied read-out [4, 512] x [512, 51865] differed from the
# batch-1 bits in 1824 outputs over 64 draws of 4 rows, padded in none),
# and under ``Ctx.per_row_scores`` computes each slot's attention scores
# as their own product (the cross-attention scores over 1500 frames at
# batch 4 differed from batch 1's in 147 elements over 64 draws; its PV,
# the self-attention over 96 keys and every other product of the step
# did not: probes/encdec_rows.py, PERF.md).
STEP_MIN_ROWS = 64


def row_contexts(cfg: ModelConfig, ctx: Ctx, card: bool):
    """The prefill and the decode / verify step contexts: on the card
    (``card``) the row padding above and the encoder-decoder's per-slot
    scores, elsewhere ``ctx`` as it is."""
    prefill = dataclasses.replace(ctx, min_rows=PREFILL_MIN_ROWS if card else 0)
    step_rows = STEP_MIN_ROWS if card else 0
    step = dataclasses.replace(ctx, step_min_rows=step_rows,
                               min_rows=step_rows if cfg.family == "moe" else 0,
                               per_row_scores=card and cfg.family == "encdec")
    return prefill, step


def _slice_tree(tree, lo: int, n: int):
    """Layers ``lo .. lo + n`` of a stacked tree, as views."""
    return kv_cache.tree_map(lambda v: v[lo:lo + n], tree)


def _sinusoid(length: int, d: int):
    """The encoder's fixed sinusoid position table [length, d] (f32 numpy,
    the reference's)."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, d, 2) / d * -np.log(10000.0))
    table = np.zeros((length, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


# the logical axes of each parameter leaf, as the reference's ``*_init``
# label them (``Model.param_axes``): dense weights by the name of their
# dense, inside a stacked layer after the leading "stacked"
_DENSE_AXES = {
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"), "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"), "wdq": ("embed", "kv_lora"), "wuq": ("kv_lora", "heads"),
    "wdkv": ("embed", "kv_lora"), "wkr": ("embed", None), "wuk": ("kv_lora", "heads"),
    "wuv": ("kv_lora", "heads"), "gate": ("embed", "mlp"), "up": ("embed", "mlp"),
    "down": ("mlp", "embed"), "router": ("embed", "experts"),
    "in_proj": ("embed", "heads"), "out_proj": ("heads", "embed"),
}
_SSM_AXES = {"conv_w": (None, "heads"), "conv_b": ("heads",), "dt_bias": ("heads",),
             "A_log": ("heads",), "D": ("heads",), "beta": (None,), "gamma": (None,)}


def _leaf_axes(path, ndim: int, expert: dict):
    """The reference's logical axes of the parameter at ``path`` (its keys)
    with ``ndim`` dimensions; ``expert``: the expert leaves' axes
    (``moe.expert_axes``)."""
    top = path[0]
    if top == "embed":
        return ("vocab", "embed")
    if top == "head":
        return ("embed", "vocab")
    if top == "pos_embed":
        return (None, "embed")
    if top in ("final_norm", "enc_final_norm"):
        return ("embed",)
    inner = path[2:] if top == "stack" else path[1:]
    leaf, parent = inner[-1], inner[-2] if len(inner) > 1 else None
    if any("norm" in k for k in inner[:-1]):
        ax = ("embed",)
    elif leaf in _SSM_AXES:
        ax = _SSM_AXES[leaf]
    elif parent in expert and ndim == 4:
        ax = expert[parent]
    elif parent in _DENSE_AXES:
        ax = _DENSE_AXES[parent] if leaf == "w" else _DENSE_AXES[parent][-1:]
    else:
        raise ValueError(f"no logical axes for parameter {'/'.join(path)}")
    return ("stacked",) + ax


def _no_tail_or_verify(cfg, what: str):
    if cfg.family == "encdec" or cfg.rope_type == "mrope":
        raise NotImplementedError(
            f"{what} covers the decoder-only lm families with scalar-position rope "
            f"({cfg.name}: {'the encoder-decoder' if cfg.family == 'encdec' else 'M-RoPE'}"
            ", as the reference)")


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec")
                or cfg.attention not in ("gqa", "mla")
                or cfg.rope_type not in ("rope", "none", "mrope")):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r}, attention {cfg.attention!r}, "
                f"rope {cfg.rope_type!r} is not a configuration of the reference")
        self.cfg = cfg
        self.ctx = Ctx(dtype=dtype)
        self.device = resolve_device(device)
        self.prefill_ctx, self.step_ctx = row_contexts(cfg, self.ctx,
                                                       self.device.type == "cuda")
        self._sinusoids: dict = {}   # (encoder length, device) -> its table

    # ------------------------------------------------------------------ init

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: Optional[torch.dtype] = None):
        """Random parameters with the reference's init distributions (normal,
        std 0.02 for the embedding and 1/sqrt(d_in) for each dense layer and
        expert matrix), drawn from ``generator`` (on the model's device;
        seed 0 when None). Weight matrices are stored in ``dtype``: the
        compute dtype when None (serving), f32 for training's master weights,
        which the forward casts at each use as the reference does; each is
        drawn in f32 and then cast, so a compute-dtype tree equals the f32
        tree cast. Norm parameters are f32; expert matrices are drawn one
        layer at a time (a stacked f32 draw of dbrx-132b's ``gate`` alone
        would take 16.9 GB). The torch and JAX generators differ, so parity
        tests load the reference's parameters through
        ``convert.params_from_numpy``."""
        cfg, dev = self.cfg, self.device
        dt = self.ctx.dtype if dtype is None else dtype
        g = generator
        if g is None and dev.type != "meta":
            g = torch.Generator(dev).manual_seed(0)

        def normal(shape, std, dtype=dt):
            w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
            return (w * std).to(dtype)

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
            return lo + (hi - lo) * u

        def dense(n, d_in, d_out, bias=False):
            p = {"w": normal((n, d_in, d_out), 1.0 / math.sqrt(d_in))}
            if bias:
                p["b"] = torch.zeros((n, d_out), dtype=dt, device=dev)
            return p

        def experts(n, shape, std):
            w = torch.empty((n,) + shape, dtype=dt, device=dev)
            for i in range(n):
                w[i] = normal(shape, std)
            return {"w": w}

        def norm(layers, width=cfg.d_model, kind=cfg.norm):
            lead = (layers,) if layers else ()
            ones = torch.ones(lead + (width,), device=dev)
            if kind == "layernorm_np":
                return {}
            if kind == "layernorm":
                return {"scale": ones, "bias": torch.zeros_like(ones)}
            return {"scale": ones}

        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

        def ssm(n):
            """``ssm_init``: dt_bias is softplus^-1 of a log-uniform dt in
            [0.001, 0.1], A_log the log of U(1, 16); conv and the per-head
            vectors in f32, as the reference reads them."""
            di, ns, gr, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_nheads
            conv_dim = di + 2 * gr * ns
            dt_ = torch.exp(uniform((n, nh), math.log(0.001), math.log(0.1)))
            return {"in_proj": dense(n, d, 2 * di + 2 * gr * ns + nh),
                    "conv_w": normal((n, cfg.ssm_conv, conv_dim), cfg.ssm_conv ** -0.5,
                                     torch.float32),
                    "conv_b": torch.zeros((n, conv_dim), device=dev),
                    "dt_bias": dt_ + torch.log(-torch.expm1(-dt_)),
                    "A_log": torch.log(uniform((n, nh), 1.0, 16.0)),
                    "D": torch.ones((n, nh), device=dev),
                    "gate_norm": norm(n, di, "rmsnorm"),
                    "out_proj": dense(n, di, d)}

        def attention(n):
            attn = {"wq": dense(n, d, h * dh, cfg.qkv_bias),
                    "wk": dense(n, d, kv * dh, cfg.qkv_bias),
                    "wv": dense(n, d, kv * dh, cfg.qkv_bias),
                    "wo": dense(n, h * dh, d)}
            backend = spec_backend(cfg.softmax)
            if getattr(backend, "learnable", False):
                # learnable softmax parameters (ConSmax beta/gamma): one
                # f32 scalar per query head and layer, at the backend
                # cfg's operating point (MLA carries none, as the
                # reference)
                c = backend.cfg
                attn["smx"] = {"beta": torch.full((n, h), c.beta, device=dev),
                               "gamma": torch.full((n, h), c.gamma, device=dev)}
            return attn

        def glu(n):
            return {"gate": dense(n, d, cfg.d_ff), "up": dense(n, d, cfg.d_ff),
                    "down": dense(n, cfg.d_ff, d)}

        def block(n, kind):
            if kind == "ssm":
                return {"norm1": norm(n), "ssm": ssm(n)}
            if kind == "hybrid":
                return {"norm1": norm(n), "attn": attention(n), "ssm": ssm(n),
                        "attn_norm": norm(n, kind="rmsnorm"),
                        "ssm_norm": norm(n, kind="rmsnorm"),
                        "norm2": norm(n), "mlp": glu(n)}
            if cfg.attention == "mla":
                attn = {k: dense(n, *shape) for k, shape in mla_dense_shapes(cfg).items()}
                if cfg.q_lora_rank:
                    attn["q_norm"] = norm(n, cfg.q_lora_rank, "rmsnorm")
                attn["kv_norm"] = norm(n, cfg.kv_lora_rank, "rmsnorm")
            else:
                attn = attention(n)
            if kind == "moe":
                ffn = {"router": dense(n, d, cfg.n_experts)}
                ffn.update({k: experts(n, shape, std)
                            for k, (shape, std) in moe_shapes(cfg).items()})
                if cfg.n_shared_experts:
                    f = cfg.n_shared_experts * cfg.d_ff_expert
                    ffn["shared"] = {"gate": dense(n, d, f), "up": dense(n, d, f),
                                     "down": dense(n, f, d)}
            else:
                ffn = glu(n)
            return {"norm1": norm(n), "norm2": norm(n), "attn": attn, "ffn": ffn}

        p = {"embed": {"w": normal((cfg.vocab, d), 0.02)},
             "final_norm": norm(0)}
        if not cfg.tie_embeddings:
            p["head"] = {"w": normal((d, cfg.vocab), 1.0 / math.sqrt(d))}
        if cfg.family == "encdec":
            n = cfg.n_layers
            p["pos_embed"] = normal((cfg.max_seq, d), 0.01)
            p["enc_stack"] = block(n, "dense")
            p["enc_final_norm"] = norm(0)
            p["dec_stack"] = {"norm1": norm(n), "self": attention(n), "norm_x": norm(n),
                              "cross": attention(n), "norm2": norm(n), "mlp": glu(n)}
        elif cfg.family == "ssm":
            p["stack"] = {"layers": block(cfg.n_layers, "ssm")}
        elif cfg.family == "hybrid":
            wa, wb = kv_cache.hybrid_segments(cfg)
            p["stack"] = {"full": block(3, "hybrid"), "win_a": block(wa, "hybrid"),
                          "win_b": block(wb, "hybrid")}
        elif cfg.family == "moe":
            p["stack"] = {"layers": block(cfg.n_layers - cfg.n_dense_prefix, "moe")}
            if cfg.n_dense_prefix:
                p["stack"]["prefix"] = block(cfg.n_dense_prefix, "dense")
        else:
            p["stack"] = {"layers": block(cfg.n_layers, "dense")}
        return p

    def param_axes(self):
        """The reference's logical axes of every parameter (``Model.
        param_axes``: a tree of tuples beside the parameter tree), from the
        tree ``init`` builds on the meta device: nothing is allocated at any
        scale."""
        meta = Model(self.cfg, self.ctx.dtype, device="meta").init()
        expert = expert_axes(self.cfg)

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            return _leaf_axes(path, node.ndim, expert)

        return walk(meta, ())

    # -------------------------------------------------------------- pieces

    def _segments(self, p):
        """The stack's homogeneous runs in layer order: (stacked params,
        kind, cache segment, first layer of the run in that segment, its
        layers). The MoE family runs its dense prefix first (the
        reference's ``_stack_*`` split) over the one cache (segment None);
        the hybrid runs full[0], win_a, full[1], win_b, full[2], each on its
        own cache segment."""
        cfg, sp = self.cfg, p["stack"]
        if cfg.family == "hybrid":
            full = lambda j: _slice_tree(sp["full"], j, 1)
            runs = [(full(0), "hybrid_full", "full", 0), (sp["win_a"], "hybrid_win", "win_a", 0),
                    (full(1), "hybrid_full", "full", 1), (sp["win_b"], "hybrid_win", "win_b", 0),
                    (full(2), "hybrid_full", "full", 2)]
            return [(r, k, seg, lo, tfm.n_stacked(r)) for r, k, seg, lo in runs
                    if tfm.n_stacked(r)]
        if cfg.family == "ssm":
            return [(sp["layers"], "ssm", None, 0, tfm.n_stacked(sp["layers"]))]
        if cfg.family != "moe":
            return [(sp["layers"], "dense", None, 0, tfm.n_stacked(sp["layers"]))]
        pre = [(sp["prefix"], "dense", None, 0, tfm.n_stacked(sp["prefix"]))] \
            if "prefix" in sp else []
        lo = pre[0][4] if pre else 0
        return pre + [(sp["layers"], "moe", None, lo, tfm.n_stacked(sp["layers"]))]

    @staticmethod
    def _layer_slice(tree, lo: int, n: int):
        """Layers ``lo .. lo + n`` of a cache tree (views: written in place;
        the tree itself when that is every layer)."""
        if lo == 0 and all(v.shape[0] == n for v in kv_cache.tree_leaves(tree)):
            return tree
        return _slice_tree(tree, lo, n)

    @staticmethod
    def _node(cache, seg):
        return cache if seg is None else cache[seg]

    def _stack_step(self, p, cache, x, cache_pos, positions, stack_fn, ctx):
        """One decode or verify step through every run, each on its layers
        of the one cache (views, written in place). Returns (x, staged): the
        staged tree of a verify step (``tfm.join_staged``: recurrent
        snapshots [L, T, B, ...], positional nodes the cache's own), the
        cache for a decode step."""
        staged = {}
        for sp, kind, seg, lo, n in self._segments(p):
            node = self._node(cache, seg)
            x, st = stack_fn(sp, self._layer_slice(node, lo, n), x, cache_pos, self.cfg,
                             ctx, positions, kind)
            staged.setdefault(seg, []).append((node, st))
        if stack_fn is tfm.stack_decode:
            return x, cache
        merged = {seg: tfm.join_staged(parts[0][0], [st for _, st in parts], torch.cat)
                  for seg, parts in staged.items()}
        return x, merged[None] if None in merged else merged

    @staticmethod
    def _cat_layers(caches):
        if len(caches) == 1:
            return caches[0]
        return kv_cache.tree_map(lambda *xs: torch.cat(xs), *caches)

    def _embed(self, p, tokens, batch=None):
        """Token embeddings; the VLM stub's ``embeds_override`` [B, S, d]
        takes the place of the rows ``override_mask`` [B, S] marks."""
        x = embed_apply(p["embed"], tokens, self.ctx)
        if batch is not None and "embeds_override" in batch:
            ov = self.ctx.cast(batch["embeds_override"])
            x = torch.where(batch["override_mask"].to(torch.bool)[..., None], ov, x)
        return x

    def _positions(self, batch, tokens):
        """M-RoPE's [3, B, S] streams from the batch, else the [B, S] iota."""
        if self.cfg.rope_type == "mrope":
            return batch["positions"]
        return positions_for(tokens.shape, device=tokens.device)

    # ----------------------------------------------------- encoder-decoder

    def _encode(self, p, frames, ctx: Ctx):
        """The encoder: frames [B, S_enc, d] plus the sinusoid table, the
        dense stack with full attention, the final norm."""
        cfg = self.cfg
        key = (frames.shape[1], frames.device)
        table = self._sinusoids.get(key)
        if table is None:
            table = torch.as_tensor(_sinusoid(key[0], cfg.d_model), device=frames.device)
            self._sinusoids[key] = table
        x = ctx.cast(frames) + ctx.cast(table)
        positions = positions_for(frames.shape[:2], device=frames.device)
        x, _ = tfm.stack_apply(p["enc_stack"], x, cfg, ctx, positions, "dense",
                               attn_kind="none")
        return norm_apply(p["enc_final_norm"], x, cfg.norm, ctx)

    def _dec_embed(self, p, tokens, offset):
        """Decoder embedding plus the learned position table. ``offset``
        is the first position: an int or a 0-d tensor (a uniform batch) or
        a per-row [B] tensor (each serving slot at its own length). Rows
        are clamped into the table: only a parked serving lane (position
        ``cache_len``) can reach past it, and its outputs are dropped."""
        x = embed_apply(p["embed"], tokens, self.ctx)
        steps = torch.arange(tokens.shape[1], dtype=torch.long, device=tokens.device)
        if isinstance(offset, int):
            pos = steps + offset                                   # [S]
        else:
            off = offset.to(torch.long)
            pos = off.reshape(-1, 1) + steps if off.ndim == 1 else off + steps
        table = p["pos_embed"]
        return x + self.ctx.cast(table[pos.clamp(0, table.shape[0] - 1)])

    def _encdec_logits(self, p, batch):
        cfg, ctx = self.cfg, self.ctx
        tokens = batch["tokens"]
        enc = self._encode(p, batch["frames"], ctx)
        x = self._dec_embed(p, tokens, 0)
        positions = positions_for(tokens.shape, device=tokens.device)
        sp = p["dec_stack"]
        block = tfm.remat(tfm.dec_block_apply, cfg.remat, sp)
        for i in telemetry.scan_range(tfm.n_stacked(sp)):
            x = block(tfm.layer_params(sp, i), x, enc, cfg, ctx, positions)
        return self._head(p, x)

    def _encdec_prefill(self, p, batch, cache_len: int):
        cfg, ctx = self.cfg, self.prefill_ctx
        tokens = batch["tokens"]
        enc = self._encode(p, batch["frames"], ctx)
        x = self._dec_embed(p, tokens, 0)
        positions = positions_for(tokens.shape, device=tokens.device)
        sp, caches = p["dec_stack"], []
        for i in telemetry.scan_range(tfm.n_stacked(sp)):
            x, c = tfm.dec_block_prefill(tfm.layer_params(sp, i), x, enc, cfg, ctx,
                                         positions, cache_len)
            caches.append(c)
        return (self._head(p, x[:, -1:]),
                kv_cache.tree_map(lambda *xs: torch.stack(xs), *caches))

    def _encdec_decode(self, p, cache, token, cache_pos, positions):
        cfg, ctx = self.cfg, self.step_ctx
        x = self._dec_embed(p, token, cache_pos)
        sp = p["dec_stack"]
        for i in telemetry.scan_range(tfm.n_stacked(sp)):
            x, _ = tfm.dec_block_decode(tfm.layer_params(sp, i), x,
                                        tfm.layer_params(cache, i), cache_pos, cfg, ctx,
                                        positions)
        return self._head(p, x, ctx), cache

    def _head(self, p, x, ctx: Optional[Ctx] = None):
        cfg, ctx = self.cfg, self.ctx if ctx is None else ctx
        x = norm_apply(p["final_norm"], x, cfg.norm, ctx)
        # a hybrid or encoder-decoder step pads its head too (STEP_MIN_ROWS)
        pad = ctx.step_min_rows if cfg.family in ("hybrid", "encdec") else 0
        if cfg.tie_embeddings:
            logits = embed_logits(p["embed"], x, ctx, pad)
        else:
            logits = dense_apply(p["head"], x, ctx, pad)
        return logits.to(_LOGIT_DTYPES[cfg.logits_dtype])

    # ---------------------------------------------------------------- entry

    def train_logits(self, p, batch):
        """(logits, aux) as the reference returns them: aux is the summed
        auxiliary loss of the layers, a 0-dim f32 tensor, zero for the dense
        family (only MoE layers add one: ``moe.moe_apply``)."""
        tokens = batch["tokens"]
        if self.cfg.family == "encdec":
            return (self._encdec_logits(p, batch),
                    torch.zeros((), dtype=torch.float32, device=tokens.device))
        x = self._embed(p, tokens, batch)
        positions = self._positions(batch, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for sp, kind, *_ in self._segments(p):
            x, a = tfm.stack_apply(sp, x, self.cfg, self.ctx, positions, kind)
            aux = aux + a
        return self._head(p, x), aux

    def prefill(self, p, batch, cache_len: int):
        if isinstance(p, Shards):
            return tp.prefill(self, p, batch, cache_len)
        if self.cfg.family == "encdec":
            return self._encdec_prefill(p, batch, cache_len)
        tokens = batch["tokens"]
        x = self._embed(p, tokens, batch)
        positions = self._positions(batch, tokens)
        caches = {}
        for sp, kind, seg, _, _ in self._segments(p):
            x, c = tfm.stack_prefill(sp, x, self.cfg, self.prefill_ctx, positions,
                                     cache_len, kind)
            caches.setdefault(seg, []).append(c)
        merged = {seg: self._cat_layers(cs) for seg, cs in caches.items()}
        return self._head(p, x[:, -1:]), merged[None] if None in merged else merged

    def prefill_tail(self, p, batch, prefix, prefix_len: int):
        """Prefill only the unshared tail of a prompt whose first
        ``prefix_len`` positions are resident in shared cache blocks.
        ``batch["tokens"]`` holds tokens[prefix_len:] ([B, T]); ``prefix`` is
        {"k","v": [L, B, s, KV, Dh]} (int8 with {"k_scale","v_scale": [L,
        B, s, KV]} under ``kv_quant``; MLA: {"c_kv": [L, B, s, r], "k_rope":
        [L, B, s, dr]}) gathered from the pool
        (``kv_cache.paged_prefix_view``). Returns (last_logits, tail cache
        [L, B, T, ...]) — equal to the tail slice of a whole prefill.
        Dense and MoE only, as the reference's: SSM state and window rings
        summarise the whole prefix, so those families prefill whole."""
        _no_tail_or_verify(self.cfg, "tail-only prefill")
        if self.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                "tail-only prefill covers the dense/moe (incl. MLA) families: the "
                f"{self.cfg.family} family's recurrent state summarises the whole "
                "prefix, so it always prefills in full (as the reference)")
        if isinstance(p, Shards):
            return tp.prefill_tail(self, p, batch, prefix, prefix_len)
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        positions = positions_for(tokens.shape, device=tokens.device) + prefix_len
        caches = []
        for sp, kind, _, lo, _ in self._segments(p):
            x, c = tfm.stack_prefill_tail(sp, self._layer_slice(prefix, lo, tfm.n_stacked(sp)),
                                          x, self.cfg, self.prefill_ctx, positions,
                                          prefix_len, kind)
            caches.append(c)
        return self._head(p, x[:, -1:]), self._cat_layers(caches)

    def decode_step(self, p, cache, batch, cache_pos):
        """``cache_pos``: the filled length — an int or a 0-d int tensor
        (uniform batch), or a [B] int tensor (per-row positions: each
        serving slot decodes at its own offset). A tensor stays on its
        device: the step reads no value back to the host, so a CUDA graph
        can capture it. The cache — contiguous, or paged pools with their
        block table — is written in place and returned. An M-RoPE model
        reads its rope positions from ``batch["positions"]`` [3, B, 1]; the
        encoder-decoder's learned positions and self cache are addressed
        per row, its cross K/V read from the cache."""
        token = batch["token"]
        b = token.shape[0]
        if self.cfg.rope_type == "mrope":
            positions = batch["positions"]
        elif isinstance(cache_pos, int):
            positions = torch.full((b, 1), cache_pos, dtype=torch.int32,
                                   device=token.device)
        else:
            positions = cache_pos.to(torch.int32).reshape(-1, 1).expand(b, 1)
        if isinstance(p, Shards):
            return tp.decode_step(self, p, cache, batch, cache_pos, positions)
        if self.cfg.family == "encdec":
            return self._encdec_decode(p, cache, token, cache_pos, positions)
        x = self._embed(p, token, batch)
        x, cache = self._stack_step(p, cache, x, cache_pos, positions, tfm.stack_decode,
                                    self.step_ctx)
        return self._head(p, x, self.step_ctx), cache

    def verify_step(self, p, cache, batch, cache_pos):
        """Multi-token decode for speculative verification: ``batch``
        {"token": [B, T]} (entry 0 the last committed token, entries 1..T-1
        draft proposals) in ONE forward pass at positions ``cache_pos ..
        cache_pos + T-1`` (``cache_pos`` an int, a 0-d or a [B] tensor,
        kept on its device as in ``decode_step``). Returns (logits [B, T,
        V], staged cache): ``logits[:, j]`` is the next-token distribution
        after token j — equal to what T successive ``decode_step`` calls
        give — and the staged cache holds every token's entries until
        :meth:`verify_commit`: the positional leaves are the cache's,
        written in place; the recurrent ones (SSM state and conv tail,
        window rings) are per-token snapshots [L, T, B, ...], the cache
        itself stepped to the block's last token."""
        _no_tail_or_verify(self.cfg, "verify_step")
        if isinstance(p, Shards):
            return tp.verify_step(self, p, cache, batch, cache_pos)
        token = batch["token"]
        b, t = token.shape
        positions = block_positions(cache_pos, b, t, token.device)
        x = self._embed(p, token)
        x, staged = self._stack_step(p, cache, x, cache_pos, positions, tfm.stack_verify,
                                     self.step_ctx)
        return self._head(p, x, self.step_ctx), staged

    def verify_commit(self, staged, n_accept, cache_pos, t: int, cache=None):
        """Resolve a staged verify cache once the accepted draft depth is
        known, in place: ``n_accept`` [B] int counts accepted draft tokens
        per row (0..t-1; entry 0 of the block is always kept). The rejected
        tail entries (positions ``cache_pos + n_accept + 1 .. cache_pos +
        t - 1``, contiguous or through the block table) are cleared, so the
        committed cache equals one built by stepping only the accepted
        tokens; the next write position is ``cache_pos + n_accept + 1``.
        Recurrent snapshots select the one after the last accepted token,
        copied into ``cache`` (the cache the verify step ran on; required
        when the staged tree holds snapshots). Returns the cache
        (``kv_cache.commit_staged``)."""
        if isinstance(staged, Shards):
            return tp.verify_commit(staged, n_accept, cache_pos, t)
        return kv_cache.commit_staged(staged, n_accept, cache_pos, t, into=cache)
