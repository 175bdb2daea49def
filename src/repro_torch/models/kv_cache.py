"""Decode-cache structure (port of ``src/repro/models/kv_cache.py``: the
dense, MoE, SSM, hybrid and encoder-decoder families, GQA and MLA
attention).

Layouts, as the reference's:
  contiguous : {"k","v": [L, B, C, KV, Dh]} in ``KV_DTYPE``; under
               ``cfg.kv_quant`` int8 codes plus {"k_scale","v_scale":
               [L, B, C, KV]} f32; MLA {"c_kv": [L, B, C, r], "k_rope":
               [L, B, C, dr]} in ``KV_DTYPE`` whatever ``kv_quant`` says
               (the reference has no int8 latent cache)
  paged      : {"k","v": [L, NB, BS, KV, Dh]} pools of NB blocks of BS
               tokens (int8 with {"k_scale","v_scale": [L, NB, BS, KV]}
               under ``kv_quant``; MLA: {"c_kv": [L, NB, BS, r], "k_rope":
               [L, NB, BS, dr]}), plus {"table": [L, S, C // BS]} int32
               mapping each slot's logical block to a physical one. ``NB`` is the
               sentinel of an empty table entry. The table keeps the
               reference's one identical copy per layer, so every cache
               leaf slices by layer the same way.
  ssm        : {"state": [L, B, H, P, N] f32, "conv": [L, B, k-1, Cd]}:
               O(1) in context, slot-resident in a paged cache too (no
               table: nothing to page)
  hybrid     : {"full", "win_a", "win_b"}, each {"attn": ..., "ssm": ...}:
               the 3 global layers' attention positional (contiguous, or
               paged), the window layers' a ring {"k","v": [L, B, W, KV,
               Dh], "pos": [L, B, W] int32} of W = min(window, C) slots,
               -1 where empty, slot-resident
  encdec     : {"self": {"k","v": [L, B, C, KV, Dh]}, "cross": {"k","v":
               [L, B, S_enc, KV, Dh]}} in ``KV_DTYPE`` (``kv_quant`` is
               ignored, as the reference's): the cross K/V of the slot's
               encoder frames, written at admission and read by every
               decode step; contiguous only (a paged build raises)

The functions walk the nested trees as the reference's do: a node with a
``"table"`` is paged (its pools scattered, copied and cleared through the
table); any other leaf outside such a node is slot-resident, a stripe at
batch axis 1. The pool operations treat every pool leaf alike, so they
carry the int8 scales with their codes. Unlike the reference (pure
functions returning new buffers), they write the cache IN PLACE and
return it: one pool exists per serve, and copying it per admission would
double its memory traffic. A stripe insert is a copy into the slot's
rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.distributed.collectives import Shards
from repro_torch.models.attention import _block_target, _put_rows, _write_target, block_positions
from repro_torch.models.hybrid import full_attn_layer_ids

KV_DTYPE = torch.bfloat16


def _check_family(cfg):
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec") or \
            cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention} caches are not ported")


def _leaves(cfg):
    """Per-token trailing shape and dtype of each attention cache leaf
    (bf16 for the encoder-decoder whatever ``kv_quant`` says, as the
    reference's ``_attn_cache``)."""
    if cfg.attention == "mla":
        return {"c_kv": ((cfg.kv_lora_rank,), KV_DTYPE),
                "k_rope": ((cfg.qk_rope_dim,), KV_DTYPE)}
    kv, dh = cfg.n_kv_heads, cfg.d_head
    if cfg.kv_quant and cfg.family != "encdec":
        return {"k": ((kv, dh), torch.int8), "v": ((kv, dh), torch.int8),
                "k_scale": ((kv,), torch.float32), "v_scale": ((kv,), torch.float32)}
    return {"k": ((kv, dh), KV_DTYPE), "v": ((kv, dh), KV_DTYPE)}


def hybrid_segments(cfg):
    """(len_win_a, len_win_b): the window layers between the global ones."""
    first, mid, last = full_attn_layer_ids(cfg)
    return (mid - first - 1, last - mid - 1)


def _ssm_cache(n: int, b: int, cfg, device):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"state": torch.zeros((n, b, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((n, b, cfg.ssm_conv - 1, conv_dim), dtype=KV_DTYPE,
                                device=device)}


def _attn_cache(n: int, b: int, c: int, cfg, device):
    return {k: torch.zeros((n, b, c) + w, dtype=dt, device=device)
            for k, (w, dt) in _leaves(cfg).items()}


def _ring_cache(n: int, b: int, w: int, cfg, device):
    """A window layer's ring: the attention leaves (int8 with scales under
    ``kv_quant``, as the reference's ``_attn_cache`` builds them) and the
    absolute position of each slot, per row (rows wrap on their own
    clocks), -1 where empty."""
    d = _attn_cache(n, b, w, cfg, device)
    d["pos"] = torch.full((n, b, w), -1, dtype=torch.int32, device=device)
    return d


def _paged_attn_cache(n: int, nb: int, bs: int, slots: int, n_log: int, cfg, device):
    cache = {k: torch.zeros((n, nb, bs) + w, dtype=dt, device=device)
             for k, (w, dt) in _leaves(cfg).items()}
    cache["table"] = torch.full((n, slots, n_log), nb, dtype=torch.int32, device=device)
    return cache


def _hybrid(cfg, b: int, c: int, attn, device):
    wa, wb = hybrid_segments(cfg)
    w = min(cfg.window, c)
    seg = lambda n, full: {"attn": attn(n) if full else _ring_cache(n, b, w, cfg, device),
                           "ssm": _ssm_cache(n, b, cfg, device)}
    return {"full": seg(3, True), "win_a": seg(wa, False), "win_b": seg(wb, False)}


def cache_zeros(cfg, batch: int, cache_len: int, device=None, enc_len: int = 0):
    """The contiguous decode cache, zeroed (ring positions -1). The
    encoder-decoder's holds the decoder's self-attention K/V beside the
    cross K/V of ``enc_len`` encoder frames."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return {"self": _attn_cache(cfg.n_layers, batch, cache_len, cfg, device),
                "cross": _attn_cache(cfg.n_layers, batch, enc_len, cfg, device)}
    if cfg.family == "ssm":
        return _ssm_cache(cfg.n_layers, batch, cfg, device)
    if cfg.family == "hybrid":
        return _hybrid(cfg, batch, cache_len,
                       lambda n: _attn_cache(n, batch, cache_len, cfg, device), device)
    return _attn_cache(cfg.n_layers, batch, cache_len, cfg, device)


def paged_cache_zeros(cfg, slots: int, cache_len: int, block_size: int,
                      num_blocks: int, device=None):
    """Zeroed pools and an all-sentinel table; slot-resident leaves zeroed,
    ring positions -1 (``device="meta"`` gives the shapes alone, for the
    cost meter)."""
    _check_family(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError("paged caches cover the decoder-only serving families")
    if cache_len % block_size != 0:
        raise ValueError(f"cache_len {cache_len} not a multiple of "
                         f"block_size {block_size}")
    n_log = cache_len // block_size
    if cfg.family == "ssm":
        return _ssm_cache(cfg.n_layers, slots, cfg, device)
    if cfg.family == "hybrid":
        return _hybrid(cfg, slots, cache_len,
                       lambda n: _paged_attn_cache(n, num_blocks, block_size, slots, n_log,
                                                   cfg, device), device)
    return _paged_attn_cache(cfg.n_layers, num_blocks, block_size, slots, n_log, cfg,
                             device)


def _axes_tree(struct, axes_for):
    return tree_map(lambda s: axes_for(tuple(s.shape)), struct)


def serve_cache_axes(cfg, slots: int, cache_len: int):
    """Logical axes tree matching ``cache_zeros`` for the tensor-parallel
    serve path (the reference's shape rules): contiguous per-slot caches
    shard by kv-heads (dense/GQA) or the latent dim (MLA), never by
    sequence; ring and SSM leaves are replicated."""
    def axes_for(shape):
        rank = len(shape)
        if rank == 5 and shape[3] == cfg.n_kv_heads:   # [L,S,C,KV,Dh]
            return ("stacked", "batch", None, "kv_heads", None)
        if rank == 4 and shape[-1] == cfg.n_kv_heads and cfg.kv_quant:   # scales
            return ("stacked", "batch", None, "kv_heads")
        if rank == 4 and cfg.attention == "mla" and shape[-1] == cfg.kv_lora_rank:
            return ("stacked", "batch", None, "latent")
        return ("stacked", "batch") + (None,) * (rank - 2)

    return _axes_tree(cache_zeros(cfg, slots, cache_len, device="meta"), axes_for)


def paged_cache_axes(cfg, slots: int, cache_len: int, block_size: int, num_blocks: int):
    """Logical axes tree matching ``paged_cache_zeros`` for tensor-parallel
    serving (the reference's shape rules): pool leaves partition by
    kv-heads (dense/GQA) or the MLA latent dim, while block tables, the
    rope-key pool and rings stay replicated."""
    def axes_for(shape):
        rank = len(shape)
        if rank == 5 and shape[3] == cfg.n_kv_heads:   # pool [L,NB,BS,KV,Dh]
            return ("stacked", None, None, "kv_heads", None)
        if rank == 4 and shape[-1] == cfg.n_kv_heads and cfg.kv_quant:   # scales
            return ("stacked", None, None, "kv_heads")
        if rank == 4 and cfg.attention == "mla" and shape[-1] == cfg.kv_lora_rank:
            return ("stacked", None, None, "latent")
        return ("stacked",) + (None,) * (rank - 1)     # tables, k_rope, rings

    return _axes_tree(paged_cache_zeros(cfg, slots, cache_len, block_size, num_blocks,
                                        device="meta"), axes_for)


def tree_leaves(tree):
    """The tensors of a cache tree (or of every shard's, in shard order), in
    key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, Shards):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return Shards(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def per_shard(fn):
    """``fn(cache, ...)`` on a tensor-parallel cache (a ``Shards`` list of
    per-shard caches): run for every shard, each with its own element of
    every ``Shards`` argument (prefill values, swap payloads) and the rest
    as given; the results in a ``Shards`` list. A plain cache runs ``fn``
    as it is. Host bookkeeping (tables rows, block ids) is the same for
    every shard, so each shard's table stays equal to the others'."""
    @functools.wraps(fn)
    def run(cache, *args, **kw):
        if not isinstance(cache, Shards):
            return fn(cache, *args, **kw)
        pick = lambda a, i: a[i] if isinstance(a, Shards) else a
        return Shards(fn(c, *(pick(a, i) for a in args),
                         **{k: pick(v, i) for k, v in kw.items()})
                      for i, c in enumerate(cache))
    return run


def _paged(node) -> bool:
    return isinstance(node, dict) and "table" in node


@per_shard
def insert_slot(cache, values, slot: int):
    """Write a batch-1 prefill cache ``values`` (every leaf [L, 1, ...])
    into ``slot``'s stripe of a CONTIGUOUS cache, in place (the reference
    engine's ``_insert_slot``)."""
    def put(leaf, v):
        leaf[:, slot] = v[:, 0].to(leaf.dtype)
    tree_map(put, cache, values)
    return cache


def _pools(cache):
    return [k for k in cache if k != "table"]


def contiguous_as_paged(cache, block_size: int):
    """A contiguous cache ({leaf: [L, B, C, ...]}, C a multiple of
    ``block_size``) seen as a paged one over the same storage: each leaf
    viewed as a pool [L, B * C // BS, BS, ...] and an identity table [L, B,
    C // BS] (slot b's logical block j is block ``b * C // BS + j``).
    Decoding through it writes and reads the contiguous stripes, through
    the paged decode path (K2 or K4 under ``int_pallas_paged``)."""
    _, b, c = next(iter(cache.values())).shape[:3]
    if c % block_size != 0:
        raise ValueError(f"cache_len {c} not a multiple of block_size {block_size}")
    n_log = c // block_size
    out = {k: leaf.view((leaf.shape[0], b * n_log, block_size) + tuple(leaf.shape[3:]))
           for k, leaf in cache.items()}
    leaf = next(iter(cache.values()))
    ident = torch.arange(b * n_log, dtype=torch.int32, device=leaf.device).reshape(b, n_log)
    out["table"] = ident.expand(leaf.shape[0], b, n_log).contiguous()
    return out


def _scatter_pools(node, values, slot: int, table_row, pb, offs, t0: int, t1: int):
    table = node["table"]
    nb, bs = node[_pools(node)[0]].shape[1:3]
    keep = (pb >= 0) & (pb < nb) & (offs >= 0) & (offs < bs)
    rows = np.nonzero(keep)[0]
    dev = table.device
    table[:, slot, :] = torch.as_tensor(np.asarray(table_row, np.int32), device=dev)
    if rows.size:
        ib = torch.as_tensor(pb[rows], dtype=torch.long, device=dev)
        io = torch.as_tensor(offs[rows], dtype=torch.long, device=dev)
        ir = torch.as_tensor(rows, dtype=torch.long, device=dev)
        for k in _pools(node):
            vals = values[k][:, 0, t0:t1].index_select(1, ir)
            node[k][:, ib, io] = vals.to(node[k].dtype)


@per_shard
def paged_scatter(cache, values, slot: int, table_row, pb, offs, t0: int,
                  t1: int):
    """Install one request's prefilled entries into the paged cache, in
    place: positions ``[t0, t1)`` of ``values`` (each pool leaf [L, 1, T,
    ...], the prefill output) land at physical coordinates ``(pb[i], offs[i])``,
    and the slot's table row becomes ``table_row``; every slot-resident
    leaf (SSM state and conv tail, window rings: [L, 1, ...]) is copied
    into the slot's stripe. ``pb``, ``offs`` and ``table_row`` are host
    integer arrays; a coordinate outside the pool is dropped, as the
    reference's scatter drops it (filtered here on the host: an
    out-of-range index on the card is a device-side assert)."""
    pb, offs = np.asarray(pb), np.asarray(offs)

    def walk(node, vals):
        if _paged(node):
            _scatter_pools(node, vals, slot, table_row, pb, offs, t0, t1)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, vals[k])
        else:
            node[:, slot] = vals[:, 0].to(node.dtype)

    walk(cache, values)
    return cache


def _paged_nodes(tree):
    """The paged nodes of a cache tree."""
    if _paged(tree):
        return [tree]
    if isinstance(tree, dict):
        return [n for v in tree.values() for n in _paged_nodes(v)]
    return []


@per_shard
def paged_copy_block(cache, src: int, dst: int):
    """Copy pool block ``src`` to ``dst`` on every pool leaf, in place (the
    device half of the allocator's copy-on-write handshake). Tables and
    slot-resident leaves are left alone."""
    for node in _paged_nodes(cache):
        for k in _pools(node):
            node[k][:, dst].copy_(node[k][:, src])
    return cache


@per_shard
def paged_prefix_view(cache, ids, s: int):
    """The shared-prefix entries (each pool leaf as [L, 1, s, ...]) gathered from
    pool blocks ``ids`` (host ints): the tail-only prefill input. A copy,
    not a view of the pool, so later writes to those blocks cannot change
    what the tail prefill reads. Only for a cache that is one paged node
    (the families that share prefixes: dense and MoE)."""
    if not _paged(cache):
        raise NotImplementedError("prefix gather requires a pure paged cache")
    out = {}
    for k in _pools(cache):
        leaf = cache[k]
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=leaf.device)
        pages = leaf.index_select(1, idx)                  # [L, n, bs, ...]
        flat = pages.reshape((leaf.shape[0], idx.shape[0] * leaf.shape[2])
                             + tuple(leaf.shape[3:]))
        out[k] = flat[:, None, :s]
    return out


@per_shard
def slot_scatter(cache, values, slot: int, dst: int, t0: int, t1: int):
    """Commit one chunk of prefilled entries into a CONTIGUOUS slot-batched
    cache, in place: positions ``[t0, t1)`` of ``values`` (each leaf [L, 1,
    T, ...]) land at stripe positions ``[dst, dst + t1 - t0)`` of ``slot``
    (the contiguous counterpart of :func:`paged_scatter` for chunked
    prefill: a first chunk passes ``dst == t0 == 0``, a tail chunk's values
    start at 0 with ``dst`` at the committed boundary). Every leaf is read
    as positional along axis 2, as the reference's ``tree.map``: only the
    chunkable families (dense and MoE) commit chunks."""
    def write(leaf, v):
        leaf[:, slot, dst:dst + t1 - t0] = v[:, 0, t0:t1].to(leaf.dtype)
    tree_map(write, cache, values)
    return cache


@per_shard
def slot_prefix_view(cache, slot: int, s: int):
    """The first ``s`` committed positions of one slot's CONTIGUOUS cache as
    [L, 1, s, ...]: the prefix input of the next ``prefill_tail`` chunk. A
    copy, like :func:`paged_prefix_view`."""
    return tree_map(lambda leaf: leaf[:, slot:slot + 1, :s].clone(), cache)


@per_shard
def swap_read(cache, slot: int, ids):
    """Snapshot one slot's paged state for preemption swap-out, as CPU
    tensors: the contents of pool blocks ``ids`` (host ints; the blocks not
    re-acquirable by content key) [L, n, bs, ...] per pool leaf, int8 codes
    with their scales, and every slot-resident stripe (SSM state and conv
    tail, window rings) [L, 1, ...]. Tables are left out: the row is host
    bookkeeping, rebuilt on resume by :func:`swap_write`. The copy is
    synchronous, so the caller may release the blocks as soon as this
    returns."""
    idx_np = np.asarray(ids, np.int64)

    def walk(node):
        if _paged(node):
            out = {}
            for k in _pools(node):
                leaf = node[k]
                idx = torch.as_tensor(idx_np, device=leaf.device)
                out[k] = leaf.index_select(1, idx).cpu()
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node[:, slot:slot + 1].to("cpu", copy=True)

    return walk(cache)


@per_shard
def swap_write(cache, payload, slot: int, ids, table_row):
    """Restore a :func:`swap_read` payload on resume, in place: the copied
    blocks land in the freshly allocated pool blocks ``ids`` (host ints),
    each table row of the slot becomes ``table_row`` (the sentinel-padded
    map over the re-acquired and restored blocks), and the slot-resident
    stripes are copied back into ``slot``. A resume that re-prefills
    nothing writes the table only here."""
    ids = np.asarray(ids, np.int64)

    def walk(node, pay):
        if _paged(node):
            table = node["table"]
            table[:, slot, :] = torch.as_tensor(np.asarray(table_row, np.int32),
                                                device=table.device)
            if ids.size:
                for k in _pools(node):
                    leaf = node[k]
                    idx = torch.as_tensor(ids, device=leaf.device)
                    leaf[:, idx] = pay[k].to(device=leaf.device, dtype=leaf.dtype)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, pay[k])
        else:
            node[:, slot] = pay[:, 0].to(device=node.device, dtype=node.dtype)

    walk(cache, payload)
    return cache


def _clear_rejected(node, rej, cache_pos, b: int, t: int, dev):
    """Zero the rejected tail entries of one positional node (contiguous
    leaves, or pools behind a table), in place."""
    if _paged(node):
        pool = node[_pools(node)[0]]
        nb, bs = pool.shape[1:3]
        target, lands = _write_target(node["table"][0], block_positions(cache_pos, b, t, dev),
                                      nb, bs)
    else:
        c = node[_pools(node)[0]].shape[2]
        target, lands = _block_target(cache_pos, b, t, c, dev)
    lands = lands & rej
    for k in _pools(node):
        leaf = node[k]
        flat = leaf.view((leaf.shape[0], leaf.shape[1] * leaf.shape[2]) + tuple(leaf.shape[3:]))
        zero = torch.zeros((b * t,) + tuple(leaf.shape[3:]), dtype=leaf.dtype, device=dev)
        _put_rows(flat, target, lands, zero)


def commit_staged(staged, n_accept, cache_pos, t: int, into=None):
    """Resolve a staged speculative-verify cache at accepted depth
    ``n_accept`` [B] (a device tensor):

      * positional leaves — contiguous ``[L, B, C, ...]`` buffers, or pools
        ``[L, NB, BS, ...]`` behind the block table, int8 codes with their
        scales — hold entries for all ``t`` verify tokens, and the rejected
        tail (positions ``cache_pos + n_accept + 1 .. cache_pos + t - 1``)
        is CLEARED to zero in place, so no drafted K/V outlives its
        rejection and the committed cache is bit-identical to one built by
        stepping only the accepted tokens. Out-of-range positions (parked
        slots at ``cache_len``, over-draft tails at the end of a request's
        budget, sentinel table entries) drop; a paged clear only ever lands
        in the slot's own private blocks, since decode positions sit
        strictly past any shared prefix;
      * recurrent nodes — SSM state and conv tail, window rings, marked by
        a ``"state"`` or ``"pos"`` leaf — arrive as per-token snapshots
        ``[L, T, B, ...]``; the snapshot after the last accepted token is
        selected per row (their updates are irreversible, so rollback is
        restore, not masking), copied into the matching leaf of ``into``
        (the cache) when given, else returned.

    Returns the resolved tree: ``into`` when given, else ``staged`` with
    its recurrent nodes replaced by their selections. No host sync and no
    data-dependent shape, so it runs inside the captured step."""
    b = n_accept.shape[0]
    dev = n_accept.device
    steps = torch.arange(t, dtype=torch.int32, device=dev)
    rej = (steps[None, :] > n_accept.to(torch.int32)[:, None]).reshape(-1)   # [B * T]
    acc = n_accept.to(torch.long)
    lanes = torch.arange(b, dtype=torch.long, device=dev)

    def walk(node, dst):
        if not isinstance(node, dict):
            raise TypeError(f"unexpected staged leaf {type(node)}")
        if "state" in node or "pos" in node:          # recurrent snapshots
            sel = {k: v[:, acc, lanes] for k, v in node.items()}
            if dst is None:
                return sel
            for k, v in sel.items():
                dst[k].copy_(v)
            return dst
        if _paged(node) or all(not isinstance(v, dict) for v in node.values()):
            _clear_rejected(node, rej, cache_pos, b, t, dev)
            return node if dst is None else dst
        return {k: walk(v, None if dst is None else dst[k]) for k, v in node.items()}

    out = walk(staged, into)
    return out if into is None else into
