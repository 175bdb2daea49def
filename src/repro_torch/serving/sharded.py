"""Tensor-parallel serving: heads and the paged pool across a mesh (port
of ``src/repro/serving/sharded.py``).

``Engine.serve(mesh=...)`` (or ``shards=N``) runs the continuous-batching
loop over a 1-D ``("model",)`` mesh (``launch/mesh.py``): attention heads
(dense/GQA) or the MLA latent rank shard across the axis (the MoE family's
experts too: the reference's expert parallelism, ``experts`` on the model
axis), and the paged block pool partitions with them — each shard holds its heads' slice of
every block, so per-shard pool memory drops to ~1/N, while block tables,
rope keys and the allocator's metadata stay replicated or on the host. The
allocator never learns about the mesh: block ids mean the same thing on
every shard.

The port keeps the reference's single-controller model: one process holds
a :class:`~repro_torch.distributed.collectives.Shards` list of per-shard
parameter trees and caches and runs every shard's products in turn; the
shard-local forward (``models/tensor_parallel.py``) gathers heads before
each row-parallel product, as the reference's ``tp_collect`` rule does.
Several shards may share a device, but only when the caller passes those
devices (``launch.mesh.make_serving_mesh(n, devices=[dev] * n)``).

This module is the host-side half: shard validation, parameter and cache
placement, the per-shard pool accounting, and the single-device vs sharded
consistency check.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed.collectives import Shards
from repro_torch.distributed.sharding import ShardingRules, serving_rules
from repro_torch.launch.mesh import SHARDS_ON_ONE_DEVICE, visible_devices
from repro_torch.models import kv_cache

MODEL_AXIS = "model"


def validate_serving_shards(cfg, n_shards: int) -> None:
    """Reject shard counts the model cannot split evenly across, before any
    placement, with the failing dimension named: every shard owns whole
    heads (whole latent lanes for MLA) of every pool block."""
    n = int(n_shards)
    if n <= 1:
        return
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise ValueError(
            f"tensor-parallel serving shards attention heads; family "
            f"{cfg.family!r} decodes through state/ring caches that have no "
            f"head axis to split — serve it single-device (mesh=None)")
    if cfg.n_heads % n:
        raise ValueError(
            f"n_heads={cfg.n_heads} is not divisible by shards={n}; pick a "
            f"shard count dividing the head count (divisors of "
            f"{cfg.n_heads})")
    if cfg.attention == "mla":
        if cfg.kv_lora_rank % n:
            raise ValueError(
                f"kv_lora_rank={cfg.kv_lora_rank} is not divisible by "
                f"shards={n}; the MLA latent pool partitions on the rank "
                f"dim, so shards must divide it")
    elif cfg.n_kv_heads % n:
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} is not divisible by shards={n}; "
            f"the KV pool partitions on the kv-head dim, so shards must "
            f"divide it (GQA with fewer KV heads than shards would need "
            f"KV replication, which serve() does not do)")


def validate_serving_mesh(cfg, mesh) -> None:
    """A serving mesh must carry the ``"model"`` axis and split the model
    evenly across it (``validate_serving_shards``)."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(
            f"serving mesh needs a {MODEL_AXIS!r} axis to shard heads "
            f"across; got axes {tuple(mesh.axis_names)} — build one with "
            f"repro_torch.launch.mesh.make_serving_mesh(shards); "
            f"{SHARDS_ON_ONE_DEVICE}")
    validate_serving_shards(cfg, mesh.shape[MODEL_AXIS])


def _maps_to_model(rules: ShardingRules, logical: Optional[str]) -> bool:
    ax = rules.mesh_axes(logical)
    return ax == MODEL_AXIS or (isinstance(ax, tuple) and MODEL_AXIS in ax)


def _row_parallel(ax, rules: ShardingRules) -> bool:
    """A weight whose contraction feeds the replicated residual stream (wo:
    ("heads","embed"), mlp down: ("mlp","embed"), the embedding table's
    logit use: ("vocab","embed")). Sharding these would turn their product
    into partial sums added across shards, in another order than one
    device's; serving keeps them replicated and gathers their inputs."""
    return (isinstance(ax, tuple) and len(ax) >= 2 and ax[-1] == "embed"
            and any(_maps_to_model(rules, a) for a in ax[:-1]))


def model_dim(shape, axes, rules: ShardingRules, mesh) -> Optional[int]:
    """The dimension of a tensor of ``shape`` labeled ``axes`` that splits
    over ``mesh``'s model axis, or None (replicated). As the reference's
    ``sharding_for``: a dimension the shard count does not divide is not
    split."""
    for i, part in enumerate(rules.spec(axes, mesh)):
        names = (part,) if isinstance(part, str) else tuple(part or ())
        if MODEL_AXIS in names and shape[i] % mesh.shape[MODEL_AXIS] == 0:
            return i
    return None


def _shard_slice(leaf, dim: Optional[int], i: int, n: int, device):
    """Shard ``i``'s part of ``leaf`` on ``device``: a view of the leaf when
    it is there already (no copy), else a copy."""
    part = leaf if dim is None else leaf.narrow(dim, i * (leaf.shape[dim] // n),
                                                leaf.shape[dim] // n)
    return part if part.device == torch.device(device) else part.to(device)


def _shard_tree(tree, axes_tree, rules, mesh, split):
    devices = mesh.device_list()
    n = len(devices)
    out = Shards(kv_cache.tree_map(lambda v, ax: _shard_slice(v, split(v, ax), i, n, dev),
                                   tree, axes_tree)
                 for i, dev in enumerate(devices))
    out.devices = devices
    return out


def shard_params(params, axes_tree, rules: ShardingRules, mesh) -> Shards:
    """Every shard's parameter tree: column-parallel weights (q/k/v and
    their biases by heads and kv-heads, gate/up by ``mlp``, the MLA
    up-projections by heads, an untied head by ``vocab``; the MoE router and
    expert gate/up by ``experts``, or every expert's gate/up by ``mlp`` under
    ``expert_tp``) sliced on the model axis, row-parallel weights
    (:func:`_row_parallel`: the expert ``down`` among them) and norms
    whole; a dimension the shard count does not divide stays whole, as the
    reference's ``sharding_for`` places it (the shard-local forward then
    takes each shard's experts from the whole weight). A slice on the device the weight is on is a view of it, and a
    whole weight there is the weight itself, so N shards on one device
    hold each weight once. ``axes_tree`` is ``Model.param_axes()``.
    Returns a ``Shards`` list with ``.devices``."""
    def split(v, ax):
        return None if _row_parallel(ax, rules) else model_dim(v.shape, ax, rules, mesh)

    return _shard_tree(params, axes_tree, rules, mesh, split)


def place_cache(cache, axes_tree, rules: ShardingRules, mesh) -> Shards:
    """A serving cache split to the serving layout: pools partition on
    kv-heads (or the MLA latent rank), tables and rope keys are whole on
    every shard. Each shard's leaves are its own contiguous storage
    (copies), since a decode step writes them in place. The engine places
    each step shape's zeroed cache so, as the reference's does."""
    placed = _shard_tree(cache, axes_tree, rules, mesh,
                         lambda v, ax: model_dim(v.shape, ax, rules, mesh))
    return Shards(kv_cache.tree_map(lambda v: v.clone(), c) for c in placed)


def pool_report(cfg, slots: int, cache_len: int, block_size: int,
                num_blocks: int, n_shards: int,
                rules: Optional[ShardingRules] = None) -> Dict[str, float]:
    """Analytic per-shard memory accounting for one paged-serving geometry.

    Walks the real pool builder (``paged_cache_zeros`` on the meta device)
    and the serving axes from ``paged_cache_axes``, so it cannot drift from
    what serve() allocates. Partitioned bytes (pools with a model-axis dim)
    divide by ``n_shards``; replicated bytes (block tables, MLA rope keys)
    are paid in full on every shard."""
    validate_serving_shards(cfg, n_shards)
    n = max(1, int(n_shards))
    if rules is None:
        rules = serving_rules(ShardingRules(cfg.sharding_overrides))
    struct = kv_cache.paged_cache_zeros(cfg, slots, cache_len, block_size, num_blocks,
                                        device="meta")
    axes = kv_cache.paged_cache_axes(cfg, slots, cache_len, block_size, num_blocks)
    part, repl = [0], [0]

    def count(s, ax):
        nbytes = int(np.prod(s.shape, dtype=np.int64)) * s.element_size()
        if any(_maps_to_model(rules, a) for a in ax):
            part[0] += nbytes
        else:
            repl[0] += nbytes

    kv_cache.tree_map(count, struct, axes)
    total = part[0] + repl[0]
    per_device = part[0] // n + repl[0]
    return {"total_bytes": float(total),
            "partitioned_bytes": float(part[0]),
            "replicated_bytes": float(repl[0]),
            "per_device_bytes": float(per_device),
            "capacity_ratio": total / max(per_device, 1),
            "shards": float(n)}


@dataclasses.dataclass
class ConsistencyReport:
    """Outcome of a single-device vs sharded serve of the same trace."""
    matched: bool
    n_requests: int
    shards: int
    mismatched_rids: List[int]

    def __bool__(self) -> bool:
        return self.matched


def check_sharded_consistency(engine, requests, shards: Optional[int] = None,
                              mesh=None, **serve_kw) -> ConsistencyReport:
    """Serve ``requests`` twice — single-device and sharded — and compare
    every request's full token stream. Returns a report; ``bool(report)``
    is the pass/fail."""
    from repro_torch.serving.options import ServeOptions

    reqs = list(requests)
    base = engine.serve(reqs, ServeOptions(**serve_kw))
    shrd = engine.serve(reqs, ServeOptions(mesh=mesh, shards=shards, **serve_kw))
    base_by, shrd_by = base.by_rid(), shrd.by_rid()
    bad = [rid for rid in sorted(base_by)
           if not np.array_equal(base_by[rid].tokens, shrd_by[rid].tokens)]
    n = (mesh.shape[MODEL_AXIS] if mesh is not None
         else (shards if shards is not None else len(visible_devices(
             engine.model.device.type))))
    return ConsistencyReport(matched=not bad, n_requests=len(reqs),
                             shards=int(n), mismatched_rids=bad)
