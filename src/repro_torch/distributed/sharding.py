"""Logical-axis sharding rules: the single place where tensor dimensions
meet mesh axes (a copy of the rules of ``src/repro/distributed/sharding.py``).

Tensors carry *logical* axis names ("batch", "seq", "heads", "mlp", ...); a
rules table maps each name to zero or more *mesh* axes. Models only ever
talk logical names, so re-sharding an architecture is a rules edit, not a
model edit.

Default mapping (production mesh ("pod", "data", "model")):

  batch    -> (pod, data)   pure DP for activations
  embed    -> (pod, data)   FSDP: d_model dim of weights sharded over DP axes
  heads    -> model         TP over attention heads
  kv_heads -> model         TP over KV heads
  mlp      -> model         TP over FFN hidden
  vocab    -> model         TP over embedding/logits vocab dim
  experts  -> model         expert parallelism
  seq_sp   -> model         sequence sharding of the residual stream (train)
  kv_seq   -> model         split-KV decode sharding
  stacked  -> None          stacked layer dim, never sharded

``ShardingRules.spec`` gives the reference's ``PartitionSpec`` as a plain
tuple of mesh-axis names (None, a name, or a tuple of names per dimension,
trailing Nones dropped). The reference's constraint helpers
(``logical_constraint``, ``use_mesh``) are XLA's; the port's tensor-parallel
forward gathers explicitly (``distributed/collectives.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]

DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "seq": None,
    "seq_sp": "model",
    "kv_seq": "model",
    "kv_lora": None,
    "latent": None,      # MLA latent CACHE dim (serve-path TP shards it)
    # the collect point before a row-parallel contraction (attention out
    # before wo, MLP hidden before down): "model" leaves the operand as the
    # producing product emits it; the serving rules map it to None, which
    # gathers the operand so the contraction runs whole on every device
    "tp_collect": "model",
    "head_dim": None,
    "state": None,
    "conv": None,
    "stacked": None,
    "cross_seq": None,
}


class ShardingRules:
    """Immutable logical->mesh rules with per-arch overrides."""

    def __init__(self, overrides: Sequence[Tuple[str, AxisVal]] = (),
                 base: Optional[Mapping[str, AxisVal]] = None):
        rules = dict(base if base is not None else DEFAULT_RULES)
        for k, v in overrides:
            rules[k] = tuple(v) if isinstance(v, list) else v
        self._rules = rules

    def mesh_axes(self, logical: Optional[str]) -> AxisVal:
        if logical is None:
            return None
        if logical not in self._rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self._rules[logical]

    def spec(self, logical_axes: Sequence[Optional[str]], mesh=None) -> tuple:
        """The mesh axes of a tensor labeled with logical axes, one entry a
        dimension (the reference's ``PartitionSpec`` entries). Mesh axes not
        present in ``mesh`` (e.g. "pod" on a single-pod mesh) are dropped;
        a mesh axis is used by one dimension at most."""
        avail = set(mesh.axis_names) if mesh is not None else None
        used: set = set()
        parts = []
        for name in logical_axes:
            ax = self.mesh_axes(name)
            was_str = isinstance(ax, str)
            if was_str:
                ax = (ax,)
            if ax is not None:
                ax = tuple(a for a in ax
                           if (avail is None or a in avail) and a not in used)
                used.update(ax)
            if not ax:
                parts.append(None)
            elif was_str and len(ax) == 1:
                parts.append(ax[0])
            else:
                # tuple-valued rules stay tuples even when filtering leaves
                # one axis, as the reference's PartitionSpec keeps them
                parts.append(tuple(ax))
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


# Tensor-parallel serving (Engine.serve(mesh=...)): decode parallelism comes
# from sharding attention heads / MLA latents, not from splitting the KV
# sequence, so "kv_seq" is unmapped and the MLA latent cache dim takes the
# model axis instead. "seq_sp" is unmapped (decode activations are [S, 1,
# d]), and "tp_collect" -> None turns every row-parallel contraction into
# gather-then-full-product: greedy sharded decode emits the single-device
# token stream instead of drifting on partial-sum order.
SERVING_OVERRIDES = (("kv_seq", None), ("seq_sp", None),
                     ("latent", "model"), ("tp_collect", None))


def serving_rules(base: Optional[ShardingRules] = None) -> ShardingRules:
    """Rules for the tensor-parallel serve path, layered over an arch's own
    rules: heads/kv_heads/mlp/vocab stay on the model axis, kv_seq is never
    sharded (head TP replaces split-KV for decode), and the MLA latent cache
    dim maps to the model axis so the paged latent pool partitions per
    device."""
    return ShardingRules(SERVING_OVERRIDES,
                         base=base._rules if base is not None else None)
