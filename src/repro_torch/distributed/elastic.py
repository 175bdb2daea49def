"""Elastic scaling: re-plan the mesh on node loss or gain without touching
model code (port of ``src/repro/distributed/elastic.py``).

Policy: the "model" axis is sacred (the TP topology is wired into every
layer's shardings); elasticity reshapes the pure-DP axes ("pod" x "data").
Every tensor's logical axes are independent of the device count, so a tree
moves onto a new mesh by its axes alone (:func:`reshard_tree`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.distributed.collectives import Shards
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import Mesh
from repro_torch.models.kv_cache import tree_map


def plan_mesh(n_devices: int, model_parallel: int = 16,
              prefer_pods: bool = True) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable (pod, data, model) shape for the devices that survived.
    Drops stragglers that don't fit a full data row (documented waste)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}")
    rows = n_devices // model_parallel
    if prefer_pods and rows % 2 == 0 and rows >= 4:
        return (2, rows // 2, model_parallel), ("pod", "data", "model")
    return (rows, model_parallel), ("data", "model")


def make_elastic_mesh(n_devices: int, model_parallel: int = 16) -> Mesh:
    """The planned mesh for ``n_devices`` as a shape (the port places
    nothing across hosts: ROADMAP.md Queue 1 item 23)."""
    shape, names = plan_mesh(n_devices, model_parallel)
    return Mesh(None, names, shape)


def _piece(leaf, spec, mesh: Mesh, coords):
    """The block of ``leaf`` the device at ``coords`` holds under ``spec``
    (a dimension over several mesh axes splits row-major over them)."""
    for dim, part in enumerate(spec):
        names = () if part is None else ((part,) if isinstance(part, str) else tuple(part))
        if not names:
            continue
        count, pos = 1, 0
        for name in names:
            size = mesh.shape[name]
            count *= size
            pos = pos * size + coords[mesh.axis_names.index(name)]
        if leaf.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {leaf.shape[dim]} does not split over "
                             f"mesh axes {names} ({count} ways)")
        width = leaf.shape[dim] // count
        leaf = leaf.narrow(dim, pos * width, width)
    return leaf


def reshard_tree(tree, axes_tree, mesh: Mesh, rules: ShardingRules) -> Shards:
    """Move a tree onto ``mesh`` by its logical axes: every device's block of
    every leaf (on that device), in mesh order — the whole elastic-restart
    data move in one call. Returns a ``Shards`` list with ``.devices``."""
    devices = mesh.device_list()
    grid = np.arange(len(devices)).reshape(mesh.dims)
    out = Shards()
    for flat, dev in enumerate(devices):
        coords = [int(c[0]) for c in np.nonzero(grid == flat)]
        out.append(tree_map(lambda v, ax: _piece(v, rules.spec(ax, mesh), mesh,
                                                 coords).to(dev), tree, axes_tree))
    out.devices = devices
    return out


def survivors_after_failure(mesh: Mesh, failed: int) -> int:
    """How many devices remain usable when ``failed`` chips die, rounding down
    to whole data rows (a failed chip poisons its model-parallel row)."""
    total = mesh.size
    model = mesh.shape.get("model", 1)
    worst_rows_lost = min(failed, total // model)
    return total - worst_rows_lost * model
