"""Host-to-device batch placement under a mesh (port of
``src/repro/data/sharding.py``)."""

from __future__ import annotations

import torch

from repro_torch.distributed.elastic import reshard_tree
from repro_torch.distributed.sharding import ShardingRules


def batch_axes(batch):
    """Logical axes for a host batch: leading dim is always "batch" except the
    M-RoPE positions tensor [3, B, S]."""
    def axes(k, v):
        if k == "positions" and v.ndim == 3 and v.shape[0] == 3:
            return (None, "batch", None)
        return ("batch",) + (None,) * (v.ndim - 1)
    return {k: axes(k, v) for k, v in batch.items()}


def shard_batch(batch, mesh, rules: ShardingRules):
    """numpy (or tensor) batch -> every device's block of it over the DP
    axes (``distributed.elastic.reshard_tree``): a ``Shards`` list of
    batches in mesh order."""
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    return reshard_tree(tensors, batch_axes(batch), mesh, rules)
