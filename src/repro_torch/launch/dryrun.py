"""Dry run: every (arch x input-shape) cell counted on the meta device, on
one H100 (``--mesh card``) or the reference's production meshes, with its
memory, work, collectives and roofline terms (port of
``src/repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape decode_32k --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Writes ``<out>/<mesh>/<arch>__<shape>.json`` (``--out``, default
``artifacts/dryrun`` in the working directory). A cell runs its step once on
meta tensors, which allocate nothing, so the dry run is the same on a CPU
host and beside the card, and needs no card; it changes where no entry
point of the serve or train path runs. Counted:

  flops_per_device   the products (``FlopCounterMode``'s table) one device runs;
  bytes_per_device   each aten op's operand and result bytes, unfused (an
                     op that only makes a view moves nothing);
  model_work         the cell's least work (``roofline.model_work``): its
                     ``bound_s`` is what a step's roofline share divides,
                     and its ``impl_flops`` what the port's code computes;
  collectives        the port's explicit collectives (``distributed.
                     collectives.count_collectives``): shard 0's operand
                     bytes, what one device of the mesh would send;
  memory             argument_bytes (exact), output_bytes and peak_bytes:
                     the largest sum of live storages while the step runs
                     (arguments included), without the caching allocator's
                     rounding or cuBLAS's workspace.

On a production mesh the batch divides over the data axes and the model
axis runs the port's shard-local forward over that many shards on the meta
device; the per-device figures are shard 0's program: the whole-weight
products (``wo``, ``down``, the embedding and norms: the port gathers
before them, where the reference runs them row-parallel) and shard 0's
column slices and attention. Every op that reads another shard's own
tensors (or an output of such an op) is that shard's work and is left
out; the gathers' concatenations are the collectives.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.distributed.collectives import count_collectives
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import (
    DEC_PROMPT, SHAPES, Skip, applicable, build_cell, per_device_bytes, resolve_mesh,
)

MESH_NAMES = {"card": "1 x H100", "single": "16x16", "multi": "2x16x16"}


def _tensors(tree):
    """The tensors of a tree of dicts, lists and tuples (``Shards`` lists and
    NamedTuple states among them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _storage(t):
    return t.untyped_storage()


class _Counter(TorchDispatchMode):
    """Operand and result bytes of every aten op, and the live storages: the
    storages of ``others`` (other shards' own tensors) and of every op that
    reads one are other shards' and are neither counted nor live here,
    but a concatenation that also reads shard 0's (a gather) is."""

    def __init__(self, others=()):
        super().__init__()
        self.other = {id(_storage(t)) for t in _tensors(others)}
        self._keep = [_storage(t) for t in _tensors(others)]
        self.live = self.peak = 0
        self.seen: dict = {}
        self.bytes = 0
        self.other_flops = 0
        self.ops = 0

    def track(self, t):
        s = _storage(t)
        key = id(s)
        if key in self.seen or key in self.other:
            return
        nb = s.nbytes()
        self.seen[key] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key):
        self.live -= self.seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        theirs = [id(_storage(t)) in self.other for t in ins]
        if any(theirs) and not (func is torch.ops.aten.cat.default and not all(theirs)):
            for t in outs:
                key = id(_storage(t))
                if key in self.seen:          # an in-place write into its storage
                    self._free(key)
                self.other.add(key)
                self._keep.append(_storage(t))
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.other_flops += fn(*args, **kwargs, out_val=out)
            return out
        for t in ins + outs:
            self.track(t)
        if not func.is_view:
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs
                              if id(_storage(t)) not in self.other)
        return out


def _unique_bytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        seen[id(_storage(t))] = _storage(t).nbytes()
    return sum(seen.values())


def count_cell(cell) -> dict:
    """Run ``cell`` once on its meta arguments under the counters."""
    counter = _Counter(cell.others)
    arg_bytes = {name: _unique_bytes(a) for name, a in zip(cell.names, cell.args)}
    t0 = time.perf_counter()
    with count_collectives() as coll, FlopCounterMode(display=False) as fc, counter:
        for t in _tensors(cell.args):
            counter.track(t)
        out = cell.fn(*cell.args)
    seconds = time.perf_counter() - t0
    arg_ids = {id(_storage(t)) for t in _tensors(cell.args)}
    out_bytes = sum(_storage(t).nbytes() for t in {id(_storage(t)): t
                                                   for t in _tensors(out)}.values()
                    if id(_storage(t)) not in arg_ids
                    and id(_storage(t)) not in counter.other)
    return {"flops": float(fc.get_total_flops() - counter.other_flops),
            "flops_all_shards": float(fc.get_total_flops()),
            "bytes": float(counter.bytes), "aten_ops": counter.ops,
            "collectives": coll, "argument_bytes_by_name": arg_bytes,
            "output_bytes": out_bytes,
            "peak_bytes": counter.peak, "count_s": seconds}


def run_cell(arch: str, shape, mesh="card", remat: str = "full",
             rules_overrides: tuple = (), softmax=None, keys=None, **cell_kw) -> dict:
    """Count one cell (``shape``: a ``SHAPES`` name or a ``ShapeSpec``) on
    ``mesh`` ("card", "single", "multi"). ``keys``: each row's live keys
    at a decode cell's (first) step, for ``model_work`` (default: a full
    cache; a generate cell's prompt). Raises ``specs.Skip`` for a cell the
    port does not run there."""
    mesh_name = mesh if isinstance(mesh, str) else "custom"
    m = resolve_mesh(mesh)
    n_chips = 1 if m is None else m.size
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, m if m is not None else "card", remat=remat,
                      softmax=softmax, rules_overrides=rules_overrides, **cell_kw)
    build_s = time.perf_counter() - t0
    got = count_cell(cell)
    meta = {k: v for k, v in cell.meta.items() if k != "cfg"}
    cfg = cell.meta["cfg"]
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    steps = meta.get("steps", 1)
    coll = {k: {n: x * steps for n, x in v.items()} for k, v in got["collectives"].items()}
    coll_pd = float(sum(v["per_shard_bytes"] for v in coll.values()))
    flops_pd, bytes_pd = got["flops"] * steps, got["bytes"] * steps
    terms = rl.roofline_terms(flops_pd, bytes_pd, coll_pd)
    rules = ShardingRules(tuple(cfg.sharding_overrides) + tuple(rules_overrides))
    if m is None:
        arg_pd = sum(got["argument_bytes_by_name"].values())
        port_pd = None
    else:
        arg_pd = sum(per_device_bytes(a, ax, m, rules)
                     for a, ax in zip(cell.whole, cell.axes))
        port_pd = _unique_bytes(cell.port_args if cell.port_args is not None else cell.args)
    work = rl.model_work(cfg, spec.kind, meta["batch_per_device"], spec.seq,
                         max_new=spec.max_new, cache_len=meta.get("cache_len")
                         if spec.kind in ("decode", "generate") else None, keys=keys,
                         dec_prompt=DEC_PROMPT,
                         params_dtype=cell_kw.get("params_dtype"))
    tokens = meta["batch"] * meta["seq"]
    model_fl = float("nan")
    if spec.kind == "train":
        attn = (12.0 * cfg.n_layers * meta["seq"] * cfg.n_heads * cfg.d_head * tokens
                if cfg.uses_attention else 0.0)
        model_fl = rl.model_flops_train(meta["active"], tokens, attn)
    result = {
        **meta,
        "mesh": MESH_NAMES.get(mesh_name, mesh_name),
        "n_chips": n_chips,
        "remat": remat,
        "build_s": build_s,
        "count_s": got["count_s"],
        "flops_per_device": flops_pd,
        # every model shard's products of this device's batch: one device's
        # whole step where the model is not split (model_work's impl_flops)
        "flops_model_axis": got["flops_all_shards"] * steps,
        "bytes_per_device": bytes_pd,
        "bytes_note": ("unfused: every aten op's operand and result bytes (views "
                       "move nothing); model_work.bytes is the least a step moves"),
        "aten_ops": got["aten_ops"],
        "collective_bytes_per_device": coll_pd,
        "collectives": coll,
        "memory": {
            "argument_bytes": arg_pd,
            "argument_bytes_by_name": got["argument_bytes_by_name"],
            "port_argument_bytes": port_pd,
            "output_bytes": got["output_bytes"],
            "peak_bytes": got["peak_bytes"],
            "peak_note": ("live storages at the high point of the step, arguments "
                          "included; without the caching allocator's rounding and "
                          "cuBLAS's workspace"),
        },
        "roofline": terms,
        "model_work": work,
        "model_flops_global": model_fl,
        "useful_flops_ratio": (rl.mfu_like(model_fl, flops_pd, n_chips)
                               if spec.kind == "train" else None),
    }
    if m is not None and meta["model_shards"] > 1:
        result["per_device_note"] = (
            "shard 0's program of the port's shard-local forward: its column slices "
            "and attention, and the whole-weight products after each gather (wo, down, "
            "embedding, norms), which the reference runs row-parallel; "
            "memory.argument_bytes places the arguments by the sharding rules as the "
            "reference does, memory.port_argument_bytes is what the port's shard holds; "
            "model_work is the per-device batch's least work on one device holding the "
            "whole model")
    return result


def _mesh_list(name: str):
    return {"card": ["card"], "single": ["single"], "multi": ["multi"],
            "both": ["single", "multi"]}[name]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card", choices=["card", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    failures = []
    t_all = time.perf_counter()
    for mesh_name in _mesh_list(args.mesh):
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for arch in archs:
            cfg = get_config(arch)
            for shape in shapes:
                tag = f"{arch} x {shape} [{mesh_name}]"
                path = os.path.join(outdir, f"{arch}__{shape}.json")
                skip = applicable(cfg, SHAPES[shape])
                try:
                    if skip:
                        raise Skip(skip)
                    res = run_cell(arch, shape, mesh_name, remat=args.remat)
                except Skip as e:
                    print(f"SKIP  {tag}: {e}", flush=True)
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape, "skipped": str(e)}, f,
                                  indent=1)
                    continue
                except Exception as e:  # noqa: BLE001 - reported, then the run fails
                    failures.append((tag, str(e)))
                    print(f"FAIL  {tag}: {e}", flush=True)
                    traceback.print_exc()
                    continue
                r = res["roofline"]
                print(f"OK    {tag}: {res['count_s']:.1f}s flops/dev="
                      f"{res['flops_per_device']:.3e} bytes/dev={res['bytes_per_device']:.3e} "
                      f"args={res['memory']['argument_bytes']} peak="
                      f"{res['memory']['peak_bytes']} dominant={r['dominant']} "
                      f"bound={r['bound_s']:.4g}s least={res['model_work']['bound_s']:.4g}s",
                      flush=True)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=str)
    print(f"\n{time.perf_counter() - t_all:.1f} s", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" -", t, ":", e[:200])
        raise SystemExit(1)
    print("ALL CELLS COUNTED (or skipped with their reason).")


if __name__ == "__main__":
    main()
