"""Device meshes for the port (the counterpart of
``src/repro/launch/mesh.py``).

A :class:`Mesh` is an array of torch devices with named axes, the shape of
the reference's ``jax.sharding.Mesh``. The port drives every shard from one
process (the reference's single-controller model), so a mesh is a list of
where each shard's tensors live, and one device may hold several shards:
the counterpart of XLA's simulated host devices, made only when the caller
passes the devices (``devices=[dev] * n``). The production meshes are
shapes alone: the port has no multi-host transport (ROADMAP.md Queue 1
item 21), so they place nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

SHARDS_ON_ONE_DEVICE = (
    "to put several shards on one device (CPU hosts, or one card), pass "
    "make_serving_mesh(n, devices=[device] * n), or --shards-on-one-device to "
    "the serve launcher (see README, 'Multi-device serving')")


class Mesh:
    """Devices (a numpy object array of ``torch.device``, or None for a
    mesh that is a shape alone) over named axes."""

    def __init__(self, devices, axis_names: Sequence[str],
                 shape: Optional[Tuple[int, ...]] = None):
        self.axis_names = tuple(axis_names)
        if devices is None:
            if shape is None or len(shape) != len(self.axis_names):
                raise ValueError("a mesh without devices needs one size per axis")
            self.devices = None
            dims = tuple(int(s) for s in shape)
        else:
            arr = np.array(devices, dtype=object)
            if arr.ndim != len(self.axis_names):
                raise ValueError(f"devices of shape {arr.shape} do not match axes "
                                 f"{self.axis_names}")
            for idx in np.ndindex(arr.shape):
                arr[idx] = torch.device(arr[idx])
            self.devices = arr
            dims = arr.shape
        self.dims = dims
        self.shape = dict(zip(self.axis_names, dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims, dtype=np.int64))

    def device_list(self) -> list:
        """The devices in mesh order (row-major)."""
        if self.devices is None:
            raise ValueError(f"the mesh {self.shape} is a shape alone: it places nothing")
        return list(self.devices.reshape(-1))

    def _key(self):
        devs = None if self.devices is None else tuple(str(d) for d in self.device_list())
        return (self.axis_names, self.dims, devs)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        devs = "no devices" if self.devices is None else [str(d) for d in self.device_list()]
        return f"Mesh({self.shape}, {devs})"


def visible_devices(kind: Optional[str] = None) -> list:
    """The devices a mesh may take without being told: every visible card
    for ``kind`` "cuda" (the default when torch sees one), the one CPU for
    "cpu"."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, devices not placed: single pod
    16x16 = 256 chips (data, model); multi-pod 2x16x16 = 512 chips (pod,
    data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape)


def make_host_mesh(kind: Optional[str] = None) -> Mesh:
    """What this host has: (n, 1) data x model over the visible devices."""
    return Mesh([[d] for d in visible_devices(kind)], ("data", "model"))


def make_serving_mesh(shards: Optional[int] = None, devices=None) -> Mesh:
    """1-D ("model",) mesh over the first ``shards`` of ``devices`` (default:
    the visible ones, :func:`visible_devices`) — the mesh
    ``Engine.serve(mesh=...)`` shards attention heads and the paged block
    pool across. ``shards=None`` takes every device. Raises when there are
    fewer devices than shards, naming how to ask for several shards on one
    device: nothing is put there unasked."""
    devs = list(visible_devices() if devices is None else devices)
    n = len(devs) if shards is None else int(shards)
    if n < 1:
        raise ValueError(f"shards must be >= 1, got {n}")
    if n > len(devs):
        raise ValueError(
            f"serving mesh wants {n} shards but only {len(devs)} device(s) are "
            f"visible; {SHARDS_ON_ONE_DEVICE}")
    return Mesh(devs[:n], ("model",))
