"""Atomic, manifest-driven checkpoints in the reference's on-disk layout
(port of ``src/repro/checkpoint/checkpointer.py``).

Layout (one directory per step):

    <root>/step_000000420.tmp/       # written first, renamed when complete
        manifest.json                # step, entries (shape, dtype), writers, extra
        shard_p0.npz                 # every leaf, keyed by its tree path
    <root>/step_000000420/           # atomic rename == commit

A leaf's key is its tree path joined by ``/``, named as JAX names it: dict
keys by their names, NamedTuple fields by their field names, sequence items
by their index (``TrainState`` gives ``params/embed/w``, ``opt/step``,
``opt/m/...``, ``opt/v/...``, ``error_fb/...``). So a checkpoint the
reference writes restores into the port, and one the port writes restores
into the reference. Leaves are kept in numpy dtypes (f32 master weights and
moments, the int32 step): numpy has no bf16, so a bf16 leaf raises. One
process writes every leaf (``shard_p0``, ``n_processes`` 1). A crash
mid-write leaves only a ``.tmp`` directory, which restore ignores and
``cleanup`` removes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_path(fn, tree, path: str = ""):
    """``tree`` rebuilt with each leaf replaced by ``fn(key, leaf)``; None
    is an empty subtree, as in JAX."""
    join = (lambda k: f"{path}/{k}") if path else str
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), join(f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{key}: a bf16 leaf has no numpy dtype; checkpoint the "
                            "f32 master weights")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(root: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Write a checkpoint atomically. Returns the committed directory."""
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        arrays[key] = _to_numpy(key, leaf)

    _map_with_path(put, tree)
    np.savez(os.path.join(tmp, "shard_p0.npz"), **arrays)
    manifest = {"step": step,
                "entries": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                            for k, a in arrays.items()},
                "n_processes": 1, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for d in os.listdir(root) if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def restore(root: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``: each leaf the saved
    array, with its saved dtype, on the device of the template's leaf (a
    tensor). Raises on a missing leaf or a shape that differs from the
    template's. Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(d)):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(d, fname)) as z:
                for k in z.files:
                    data[k] = z[k]

    def load(key, leaf):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {want}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(leaf.device)
        return arr

    return _map_with_path(load, tree_like), step, manifest.get("extra", {})


def cleanup(root: str, keep: int) -> None:
    """Remove stale .tmp dirs and all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(root):
        return
    for d in os.listdir(root):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    steps = sorted(int(m.group(1)) for d in os.listdir(root) if (m := _STEP_RE.match(d)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)
