"""Collectives over per-shard tensors (port of
``src/repro/distributed/collectives.py``).

The port's tensor parallelism is one process driving every shard (the
reference's single-controller SPMD): a value that differs per shard is a
:class:`Shards` list in shard order, and a collective is written out as
ordered copies and sums over it. Each result is in shard order whatever the
devices are, so a collective gives the same bits on one card (every shard
on ``cuda:0``, as the tests put them on the CPU) as across cards. Sums run
in a fixed order (shard 0 first), as a tree of pairwise adds would not.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

# the open ``count_collectives`` records (none: the calls record nothing)
_RECORDS: list = []


@contextlib.contextmanager
def count_collectives():
    """While open, every collective call adds its operand bytes and one
    call to a record ``{kind: {"calls", "operand_bytes", "per_shard_bytes"}}``
    (kinds ``all_gather``, ``psum``, ``reduce_scatter_mean``): the bytes of
    every shard's operands, and of shard 0's, which is what one device of
    a process-per-device mesh would send. Yields the record. It changes no
    result; with none open a call costs one list test."""
    rec: dict = {}
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _record(kind: str, xs) -> None:
    if not _RECORDS:
        return
    sizes = [x.numel() * x.element_size() for x in xs]
    for rec in _RECORDS:
        r = rec.setdefault(kind, {"calls": 0, "operand_bytes": 0, "per_shard_bytes": 0})
        r["calls"] += 1
        r["operand_bytes"] += sum(sizes)
        r["per_shard_bytes"] += sizes[0]


class Shards(list):
    """Per-shard values (tensors, or trees of them), in shard order; a
    parameter list from ``serving.sharded.shard_params`` carries
    ``.devices``."""


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0, device=None) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in shard order (the
    reference's tiled ``all_gather``), on ``device`` (default: shard 0's)."""
    _record("all_gather", xs)
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs], dim=dim)


def ring_all_gather(xs: Sequence[torch.Tensor], dim: int = 0, device=None) -> torch.Tensor:
    """:func:`all_gather` (the reference's name for the tiled gather)."""
    return all_gather(xs, dim, device)


def _psum(xs, device, kind: str = "psum"):
    _record(kind, xs)
    device = xs[0].device if device is None else device
    acc = xs[0].to(device)
    for x in xs[1:]:
        acc = acc + x.to(device)
    return acc


def _tree_zip(fn, trees):
    if isinstance(trees[0], dict):
        return {k: _tree_zip(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(trees)


def psum_tree(trees: Sequence, device=None):
    """Leaf by leaf, the sum over the shards' trees, added in shard order."""
    return _tree_zip(lambda xs: _psum(xs, device), list(trees))


def pmean_tree(trees: Sequence, device=None):
    """Leaf by leaf, the mean over the shards' trees (the shard-order sum
    divided by the shard count)."""
    n = len(trees)
    return _tree_zip(lambda xs: _psum(xs, device) / n, list(trees))


def reduce_scatter_mean(xs: Sequence[torch.Tensor], dim: int = 0) -> Shards:
    """The ZeRO gradient primitive: the shard-order sum of the shards'
    tensors, divided by the shard count, split along ``dim`` into equal
    tiles, tile i on shard i's device."""
    n = len(xs)
    total = _psum(xs, None, "reduce_scatter_mean") / n
    if total.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {total.shape[dim]} does not split into "
                         f"{n} tiles")
    return Shards(t.to(x.device) for t, x in zip(total.chunk(n, dim), xs))
