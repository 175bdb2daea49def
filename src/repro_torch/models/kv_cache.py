"""Decode-cache structure (port of the dense and MoE families, GQA and MLA
attention, of ``src/repro/models/kv_cache.py``).

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

The pool operations treat every leaf but the table alike, so scatter,
copy-on-write, the prefix view and the speculative rollback
(``commit_staged``) serve both families and carry the int8 scales with
their codes. Unlike the reference (pure functions returning
new buffers), they write the cache IN
PLACE and return it: one pool exists per serve, and copying it per
admission would double its memory traffic. The other families come with
ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import _block_target, _put_rows, _write_target, block_positions

KV_DTYPE = torch.bfloat16


def _dense_only(cfg):
    """The positional-cache families: dense and MoE (whose caches are the
    dense GQA or MLA leaves, one per layer, the dense prefix's first)."""
    if cfg.family not in ("dense", "moe") or cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention} caches are not ported: ROADMAP.md "
            "Queue 1 item 11")


def _leaves(cfg):
    """Per-token trailing shape and dtype of each cache leaf."""
    if cfg.attention == "mla":
        return {"c_kv": ((cfg.kv_lora_rank,), KV_DTYPE),
                "k_rope": ((cfg.qk_rope_dim,), KV_DTYPE)}
    kv, dh = cfg.n_kv_heads, cfg.d_head
    if cfg.kv_quant:
        return {"k": ((kv, dh), torch.int8), "v": ((kv, dh), torch.int8),
                "k_scale": ((kv,), torch.float32), "v_scale": ((kv,), torch.float32)}
    return {"k": ((kv, dh), KV_DTYPE), "v": ((kv, dh), KV_DTYPE)}


def cache_zeros(cfg, batch: int, cache_len: int, device=None):
    _dense_only(cfg)
    return {k: torch.zeros((cfg.n_layers, batch, cache_len) + w, dtype=dt,
                           device=device)
            for k, (w, dt) in _leaves(cfg).items()}


def paged_cache_zeros(cfg, slots: int, cache_len: int, block_size: int,
                      num_blocks: int, device=None):
    """Zeroed pools and an all-sentinel table (``device="meta"`` gives the
    shapes alone, for the cost meter)."""
    _dense_only(cfg)
    if cache_len % block_size != 0:
        raise ValueError(f"cache_len {cache_len} not a multiple of "
                         f"block_size {block_size}")
    cache = {k: torch.zeros((cfg.n_layers, num_blocks, block_size) + w,
                            dtype=dt, device=device)
             for k, (w, dt) in _leaves(cfg).items()}
    cache["table"] = torch.full((cfg.n_layers, slots, cache_len // block_size),
                                num_blocks, dtype=torch.int32, device=device)
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


def paged_scatter(cache, values, slot: int, table_row, pb, offs, t0: int,
                  t1: int):
    """Install one request's prefilled entries into the paged cache, in
    place: positions ``[t0, t1)`` of ``values`` (each pool leaf [L, 1, T,
    ...], the prefill output) land at physical coordinates ``(pb[i], offs[i])``,
    and the slot's table row becomes ``table_row``. ``pb``, ``offs`` and
    ``table_row`` are host integer arrays; a coordinate outside the pool is
    dropped, as the reference's scatter drops it (filtered here on the host:
    an out-of-range index on the card is a device-side assert)."""
    table = cache["table"]
    nb, bs = cache[_pools(cache)[0]].shape[1:3]
    pb, offs = np.asarray(pb), np.asarray(offs)
    keep = (pb >= 0) & (pb < nb) & (offs >= 0) & (offs < bs)
    rows = np.nonzero(keep)[0]
    dev = table.device
    table[:, slot, :] = torch.as_tensor(np.asarray(table_row, np.int32),
                                        device=dev)
    if rows.size:
        ib = torch.as_tensor(pb[rows], dtype=torch.long, device=dev)
        io = torch.as_tensor(offs[rows], dtype=torch.long, device=dev)
        ir = torch.as_tensor(rows, dtype=torch.long, device=dev)
        for k in _pools(cache):
            vals = values[k][:, 0, t0:t1].index_select(1, ir)
            cache[k][:, ib, io] = vals.to(cache[k].dtype)
    return cache


def paged_copy_block(cache, src: int, dst: int):
    """Copy pool block ``src`` to ``dst`` on every pool leaf, in place (the
    device half of the allocator's copy-on-write handshake)."""
    for k in _pools(cache):
        cache[k][:, dst].copy_(cache[k][:, src])
    return cache


def paged_prefix_view(cache, ids, s: int):
    """The shared-prefix entries (each pool leaf as [L, 1, s, ...]) gathered from
    pool blocks ``ids`` (host ints): the tail-only prefill input. A copy,
    not a view of the pool, so later writes to those blocks cannot change
    what the tail prefill reads."""
    out = {}
    for k in _pools(cache):
        leaf = cache[k]
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=leaf.device)
        pages = leaf.index_select(1, idx)                  # [L, n, bs, ...]
        flat = pages.reshape((leaf.shape[0], idx.shape[0] * leaf.shape[2])
                             + tuple(leaf.shape[3:]))
        out[k] = flat[:, None, :s]
    return out


def slot_scatter(cache, values, slot: int, dst: int, t0: int, t1: int):
    """Commit one chunk of prefilled entries into a CONTIGUOUS slot-batched
    cache, in place: positions ``[t0, t1)`` of ``values`` (each leaf [L, 1,
    T, ...]) land at stripe positions ``[dst, dst + t1 - t0)`` of ``slot``
    (the contiguous counterpart of :func:`paged_scatter` for chunked
    prefill: a first chunk passes ``dst == t0 == 0``, a tail chunk's values
    start at 0 with ``dst`` at the committed boundary)."""
    for k, leaf in cache.items():
        leaf[:, slot, dst:dst + t1 - t0] = values[k][:, 0, t0:t1].to(leaf.dtype)
    return cache


def slot_prefix_view(cache, slot: int, s: int):
    """The first ``s`` committed positions of one slot's CONTIGUOUS cache as
    [L, 1, s, ...]: the prefix input of the next ``prefill_tail`` chunk. A
    copy, like :func:`paged_prefix_view`."""
    return {k: leaf[:, slot:slot + 1, :s].clone() for k, leaf in cache.items()}


def swap_read(cache, slot: int, ids):
    """Snapshot one slot's paged state for preemption swap-out: the
    contents of pool blocks ``ids`` (host ints; the blocks not
    re-acquirable by content key) as CPU tensors [L, n, bs, ...] per pool
    leaf, int8 codes with their scales. The table is left out: the row is
    host bookkeeping, rebuilt on resume by :func:`swap_write`. The copy is
    synchronous, so the caller may release the blocks as soon as this
    returns. ``slot`` is kept for the reference's signature: it names the
    slot-resident stripes, which no ported family has (item 11)."""
    out = {}
    for k in _pools(cache):
        leaf = cache[k]
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=leaf.device)
        out[k] = leaf.index_select(1, idx).cpu()
    return out


def swap_write(cache, payload, slot: int, ids, table_row):
    """Restore a :func:`swap_read` payload on resume, in place: the copied
    blocks land in the freshly allocated pool blocks ``ids`` (host ints) and
    the slot's table row becomes ``table_row`` (the sentinel-padded map over
    the re-acquired and restored blocks). A resume that re-prefills nothing
    writes the table only here."""
    table = cache["table"]
    table[:, slot, :] = torch.as_tensor(np.asarray(table_row, np.int32),
                                        device=table.device)
    ids = np.asarray(ids, np.int64)
    if ids.size:
        for k in _pools(cache):
            leaf = cache[k]
            idx = torch.as_tensor(ids, device=leaf.device)
            leaf[:, idx] = payload[k].to(device=leaf.device, dtype=leaf.dtype)
    return cache


def commit_staged(staged, n_accept, cache_pos, t: int):
    """Resolve a staged speculative-verify cache at accepted depth
    ``n_accept`` [B] (a device tensor), in place: the positional leaves —
    contiguous ``[L, B, C, ...]`` buffers, or pools ``[L, NB, BS, ...]``
    behind the block table, int8 codes with their scales — hold entries
    for all ``t`` verify tokens, and the rejected tail (positions
    ``cache_pos + n_accept + 1 .. cache_pos + t - 1``) is CLEARED to zero,
    so no drafted K/V outlives its rejection and the committed cache is
    bit-identical to one built by stepping only the accepted tokens.
    Out-of-range positions (parked slots at ``cache_len``, over-draft tails
    at the end of a request's budget, sentinel table entries) drop; a paged
    clear only ever lands in the slot's own private blocks, since decode
    positions sit strictly past any shared prefix. No host sync and no
    data-dependent shape, so it runs inside the captured step. The
    recurrent families' "select the snapshot" branch (SSM state, hybrid
    rings) is not ported: ROADMAP.md Queue 1 item 11."""
    if any(k in staged for k in ("state", "pos")) or any(
            isinstance(v, dict) for v in staged.values()):
        raise NotImplementedError(
            "commit_staged of recurrent snapshots (SSM state, hybrid rings) is not "
            "ported: ROADMAP.md Queue 1 item 11")
    b = n_accept.shape[0]
    dev = n_accept.device
    steps = torch.arange(t, dtype=torch.int32, device=dev)
    rej = (steps[None, :] > n_accept.to(torch.int32)[:, None]).reshape(-1)   # [B * T]
    if "table" in staged:
        pool = staged[_pools(staged)[0]]
        nb, bs = pool.shape[1:3]
        target, lands = _write_target(staged["table"][0], block_positions(cache_pos, b, t, dev),
                                      nb, bs)
    else:
        c = staged[_pools(staged)[0]].shape[2]
        target, lands = _block_target(cache_pos, b, t, c, dev)
    lands = lands & rej
    for k in _pools(staged):
        leaf = staged[k]
        flat = leaf.view((leaf.shape[0], leaf.shape[1] * leaf.shape[2]) + tuple(leaf.shape[3:]))
        zero = torch.zeros((b * t,) + tuple(leaf.shape[3:]), dtype=leaf.dtype, device=dev)
        _put_rows(flat, target, lands, zero)
    return staged
