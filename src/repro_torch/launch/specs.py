"""Dry-run cells (port of ``src/repro/launch/specs.py``): (arch x input
shape x mesh) -> the function a step runs and its arguments as meta tensors.
Nothing is allocated on any device.

The four kinds are the port's entry points: train -> ``training/step.py``'s
train step (AdamW from f32 masters); prefill -> ``Model.prefill``; decode
-> ``Model.decode_step`` (on a paged pool when the shape names one: the
serve step); generate -> the fused generate's step (a decode step and its
greedy token) ``max_new`` times. Where the port runs one of its kernels
(``int_pallas``), a meta cell runs its plain version, which computes the
same function.

Every cell counts the rows the card's products take (``Model``'s
``PREFILL_MIN_ROWS`` / ``STEP_MIN_ROWS`` padding, which applies on CUDA
only: ``models.model.row_contexts``). Meshes: ``"card"`` is one H100; the
reference's production meshes (``launch/
mesh.py``, shapes alone) divide the batch over their data axes and run the
model axis as the port's shard-local forward (``models/tensor_parallel.py``)
over that many shards, all on the meta device; a cell the port cannot run
there raises :class:`Skip` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed.sharding import ShardingRules, serving_rules
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_serving_mesh
from repro_torch.models import kv_cache
from repro_torch.models.model import Model, row_contexts

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode | generate
    seq: int
    batch: int
    max_new: int = 0  # generate cells: decode steps (seq includes these slots)
    # the port's: a paged pool (block_size, num_blocks) for a decode cell
    # (the serve step), and a cache length other than seq
    paged: Optional[Tuple[int, int]] = None
    cache_len: int = 0


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "generate_32k": ShapeSpec("generate_32k", "generate", 32768, 128, max_new=64),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

DEC_PROMPT = 64  # whisper decoder prompt length for prefill cells


class Skip(Exception):
    """A cell the port does not run, with the reason (and its ROADMAP item)."""


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full attention is quadratic at 512k context; skipped per "
                "brief (DESIGN.md §Arch-applicability)")
    return None


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) cell: ``fn(*args)`` runs the step on one
    device's share of the work; ``meta`` describes it. ``axes`` holds the
    logical axes of each argument tree (``None``: replicated) and
    ``port_args`` what the port's program holds on one device where that
    differs from the arguments' placement under the sharding rules."""
    fn: object
    args: tuple
    meta: dict
    names: tuple = ()
    axes: tuple = ()
    port_args: Optional[tuple] = None
    others: tuple = ()        # trees of the other shards' own tensors
    whole: Optional[tuple] = None   # the arguments unsharded (placement)


def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=META)


def train_batch(cfg: ModelConfig, b: int, s: int) -> dict:
    batch = {"tokens": _zeros((b, s), torch.int32), "labels": _zeros((b, s), torch.int32)}
    if cfg.rope_type == "mrope":
        batch["positions"] = _zeros((3, b, s), torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = _zeros((b, s, cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch(cfg: ModelConfig, b: int, s: int) -> dict:
    if cfg.family == "encdec":
        return {"frames": _zeros((b, s, cfg.d_model), torch.bfloat16),
                "tokens": _zeros((b, DEC_PROMPT), torch.int64)}
    batch = {"tokens": _zeros((b, s), torch.int64)}
    if cfg.rope_type == "mrope":
        batch["positions"] = _zeros((3, b, s), torch.int32)
    return batch


def batch_axes(batch: dict) -> dict:
    """Logical axes of a batch: the leading dim is "batch", but M-RoPE's
    [3, B, S] positions."""
    return {k: ((None, "batch", None) if k == "positions" and v.ndim == 3 and v.shape[0] == 3
                else ("batch",) + (None,) * (v.ndim - 1)) for k, v in batch.items()}


def divisible_parts(shape, axes, mesh: Mesh, rules: ShardingRules) -> tuple:
    """The mesh axes each dimension of a tensor is split over, as the
    reference's ``sharding_for`` places an argument: ``rules.spec``, then
    mesh axes that do not divide a dimension dropped right-first."""
    parts = []
    for i, part in enumerate(rules.spec(axes, mesh)):
        names = () if part is None else ((part,) if isinstance(part, str) else tuple(part))
        while names:
            prod = 1
            for n in names:
                prod *= mesh.shape[n]
            if shape[i] % prod == 0:
                break
            names = names[:-1]
        parts.append(names)
    return tuple(parts)


def per_device_bytes(tree, axes_tree, mesh: Optional[Mesh], rules: ShardingRules) -> int:
    """Bytes of one device's share of ``tree`` placed by ``axes_tree`` (None:
    every leaf whole) on ``mesh``."""
    total = 0

    def leaf(t, ax):
        nonlocal total
        n = t.numel() * t.element_size()
        if ax is not None and mesh is not None:
            for names in divisible_parts(tuple(t.shape), ax, mesh, rules):
                for name in names:
                    n //= mesh.shape[name]
        total += n

    if axes_tree is None:
        kv_cache.tree_map(lambda t: leaf(t, None), tree)
    else:
        kv_cache.tree_map(leaf, tree, axes_tree)
    return total


def _data_batch(batch: int, mesh: Optional[Mesh], rules: ShardingRules) -> int:
    """One device's batch rows: the batch split over the data axes that
    divide it (replicated over the rest, as ``sharding_for``)."""
    if mesh is None:
        return batch
    (names,) = divisible_parts((batch,), ("batch",), mesh, rules)
    for n in names:
        batch //= mesh.shape[n]
    return batch


def resolve_mesh(mesh) -> Optional[Mesh]:
    if mesh in (None, "card"):
        return None
    if mesh in ("single", "multi"):
        return make_production_mesh(multi_pod=mesh == "multi")
    return mesh


def build_cell(arch: str, shape: Union[str, ShapeSpec], mesh="card", remat: str = "full",
               softmax=None, rules_overrides: tuple = (),
               n_layers_override: Optional[int] = None,
               cfg_overrides: Optional[dict] = None, params_dtype=None,
               grad_compress: bool = False) -> Cell:
    """The cell of ``arch`` at ``shape`` (a ``SHAPES`` name or a
    ``ShapeSpec``) on ``mesh`` ("card", "single", "multi" or a ``Mesh``).
    Raises ``Skip`` for a cell the port does not run there."""
    cfg = get_config(arch)
    if softmax is not None:
        cfg = cfg.with_softmax(softmax)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind not in ("train", "prefill", "decode", "generate"):
        raise ValueError(f"unknown kind {shape.kind!r}")
    skip = applicable(cfg, shape)
    if skip:
        raise Skip(skip)
    cfg = dataclasses.replace(cfg, remat=remat)
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    mesh = resolve_mesh(mesh)
    rules = ShardingRules(tuple(cfg.sharding_overrides) + tuple(rules_overrides))
    n_model = 1 if mesh is None else mesh.shape.get("model", 1)
    if n_model > 1:
        _check_model_axis(cfg, shape, n_model)
    model = Model(cfg, device=META)
    model.prefill_ctx, model.step_ctx = row_contexts(cfg, model.ctx, card=True)
    b = _data_batch(shape.batch, mesh, rules)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind, "seq": shape.seq,
            "batch": shape.batch, "batch_per_device": b, "model_shards": n_model,
            "params": cfg.param_count(), "active": cfg.active_param_count(), "cfg": cfg}
    if shape.kind == "train":
        return _train_cell(model, cfg, shape, b, params_dtype, grad_compress, meta)
    dtype = params_dtype or torch.bfloat16
    params = whole_params = model.init(dtype=dtype)
    p_axes = model.param_axes()
    port_params = None
    if n_model > 1:
        from repro_torch.serving.sharded import shard_params

        srules = serving_rules(rules)
        smesh = make_serving_mesh(n_model, devices=[META] * n_model)
        params = _own_storage(shard_params(params, p_axes, srules, smesh), params)
        port_params = params[0]
    if shape.kind == "prefill":
        batch = prefill_batch(cfg, b, shape.seq)
        cache_len = shape.seq + DEC_PROMPT

        def fn(p, bt):
            return model.prefill(p, bt, cache_len)

        meta["cache_len"] = cache_len
        return Cell(fn, (params, batch), meta, ("params", "batch"),
                    (p_axes, batch_axes(batch)),
                    None if port_params is None else (port_params, batch),
                    _others(params), (whole_params, batch))
    cache_len = shape.cache_len or shape.seq
    enc_len = shape.seq if cfg.family == "encdec" else 0
    if shape.paged:
        bs, nb = shape.paged
        cache = kv_cache.paged_cache_zeros(cfg, b, cache_len, bs, nb, device=META)
        c_axes = kv_cache.paged_cache_axes(cfg, b, cache_len, bs, nb)
    else:
        cache = kv_cache.cache_zeros(cfg, b, cache_len, device=META, enc_len=enc_len)
        c_axes = kv_cache.serve_cache_axes(cfg, b, cache_len) if cfg.family != "encdec" \
            else None
    port_cache, whole_cache = None, cache
    if n_model > 1:
        from repro_torch.serving.sharded import place_cache

        cache = place_cache(cache, c_axes, srules, smesh)
        port_cache = cache[0]
    meta["cache_len"] = cache_len
    token = _zeros((b, 1), torch.int64)
    pos = _zeros((), torch.int32) if not shape.paged else _zeros((b,), torch.int64)
    mrope = cfg.rope_type == "mrope"

    def step_inputs(tok, p_):
        inputs = {"token": tok}
        if mrope:
            inputs["positions"] = p_.to(torch.int32).reshape(1, -1, 1).expand(3, b, 1)
        return inputs

    # a generate cell is the fused generate's step (the decode step and its
    # greedy token), counted once: its max_new steps repeat the same work
    meta["steps"] = shape.max_new if shape.kind == "generate" else 1

    def fn(p, c, tok, p_):
        logits, c = model.decode_step(p, c, step_inputs(tok, p_), p_)
        if shape.kind == "generate":
            return torch.argmax(logits[:, -1], dim=-1)[:, None], c
        return logits, c

    return Cell(fn, (params, cache, token, pos), meta, ("params", "cache", "token", "pos"),
                (p_axes, c_axes, ("batch", None), ("batch",) if shape.paged else None),
                None if port_params is None else (port_params, port_cache, token, pos),
                _others(params) + (tuple(cache[1:]) if n_model > 1 else ()),
                (whole_params, whole_cache, token, pos))


def _others(params) -> tuple:
    """The tensors of shards 1.. that are their own (their column slices),
    not the whole weights every shard shares."""
    from repro_torch.distributed.collectives import Shards

    if not isinstance(params, Shards):
        return ()
    shared = {id(v) for v in kv_cache.tree_leaves(params[0])}
    return tuple(v for t in params[1:] for v in kv_cache.tree_leaves(t) if id(v) not in shared)


def _own_storage(shards, whole):
    """Each shard's column slices as tensors of their own (on the meta
    device a slice is a view of the whole weight), so a shard's storages
    are its own: one device's memory, and whose work an op is, read off
    the storages an op touches."""
    from repro_torch.distributed.collectives import Shards

    def own(v, w):
        return torch.empty_like(v) if v.shape != w.shape else v

    out = Shards(kv_cache.tree_map(own, t, whole) for t in shards)
    out.devices = shards.devices
    return out


def _check_model_axis(cfg: ModelConfig, shape: ShapeSpec, n: int) -> None:
    """Raise ``Skip`` for a cell the port's model axis cannot run."""
    if shape.kind == "train":
        raise Skip("training on a model axis is not ported: ROADMAP.md Queue 1 item 23 "
                   "(sharded training; launch/train.py --production-mesh raises)")
    from repro_torch.serving.sharded import validate_serving_shards

    try:
        validate_serving_shards(cfg, n)
    except ValueError as e:
        raise Skip(f"Engine.serve refuses to shard it over {n} shards (ROADMAP.md Queue 1 "
                   f"item 14): {e}") from None


def _train_cell(model, cfg, shape, b, params_dtype, grad_compress, meta) -> Cell:
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.step import TrainState, init_state, make_train_step

    opt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000))
    state = init_state(model, opt, grad_compress=grad_compress)
    if params_dtype is not None:
        state = TrainState(kv_cache.tree_map(lambda v: v.to(params_dtype), state.params),
                           state.opt, state.error_fb)
    step = make_train_step(model, opt, grad_compress=grad_compress)
    batch = train_batch(cfg, b, shape.seq)
    return Cell(step, (state, batch), meta, ("state", "batch"), (None, batch_axes(batch)))
