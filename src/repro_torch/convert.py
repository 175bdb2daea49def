"""Reference parameters -> the port's parameters.

The input is the reference ``Model.init`` tree with its ``Param`` leaves
turned into numpy arrays by the caller (the tests do
``jax.tree.map(np.asarray, split_tree(params)[0])``; this module never
imports JAX). Layouts are the same — including the leading ``"stacked"``
layer axis — so the conversion is a tree map that moves each array to the
device: weight matrices and dense biases (``"w"``, ``"b"``) to the compute
dtype, where the reference casts them at every use; norm parameters
(``"scale"``, ``"bias"``) and learnable softmax parameters (``"smx"``:
ConSmax's ``"beta"``, ``"gamma"``) stay f32, as the reference reads them.
The MoE family's leaves are of the same kinds: the router ``[L, d, E]``,
the stacked expert matrices ``gate`` / ``up`` ``[L, E, d, f]`` and
``down`` ``[L, E, f, d]``, the shared GLU, and the dense ``prefix``
stack beside ``layers``. The SSM block's ``conv_w`` ``[L, k, Cd]``,
``conv_b``, ``dt_bias``, ``A_log`` and ``D`` stay f32 (the reference
casts ``conv_w``, ``conv_b`` and ``D`` where it uses them and reads the
others in f32), its ``gate_norm`` and the hybrid's ``attn_norm`` /
``ssm_norm`` are norms; the hybrid's stack has the segments ``full`` /
``win_a`` / ``win_b``. The encoder-decoder's tree has no ``stack``: its
``pos_embed`` ``[max_seq, d]`` (the decoder's learned positions, to the
compute dtype, where the reference casts what it reads), the dense
``enc_stack`` and ``enc_final_norm``, and ``dec_stack`` with its
``norm1`` / ``self`` / ``norm_x`` / ``cross`` / ``norm2`` / ``mlp``
subtrees. Qwen2-VL's QKV biases are dense biases (``"b"``).

With ``dtype=torch.float32`` the weights stay the reference's f32 values:
the master weights training takes (the forward casts them to the compute
dtype at each use, as the reference does). ``train_state_from_numpy``
carries a whole reference ``TrainState`` over (params, AdamW moments and
step, the compression residual), and ``cast_weights`` turns master
weights into a serving tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState
from repro_torch.training.step import TrainState

# the leaves the reference casts to the compute dtype where it reads them
_WEIGHTS = ("w", "b", "pos_embed")


def params_from_numpy(tree, cfg, device, dtype: torch.dtype = torch.bfloat16):
    """Nested dict of numpy arrays (reference layout) -> nested dict of
    tensors on ``device`` for ``repro_torch.models.model.Model(cfg)``: the
    weights in ``dtype`` (the model's compute dtype for serving; f32 for
    master weights), the rest f32. Raises on a leaf or a stack segment the
    port does not know."""
    if cfg.family == "encdec":
        top = {"embed", "final_norm", "head", "pos_embed", "enc_stack", "enc_final_norm",
               "dec_stack"}
        if not set(tree) <= top:
            raise ValueError(f"unexpected encoder-decoder subtrees {sorted(set(tree) - top)}")
    else:
        segments = {"moe": {"layers", "prefix"},
                    "hybrid": {"full", "win_a", "win_b"}}.get(cfg.family, {"layers"})
        if not set(tree["stack"]) <= segments:
            raise ValueError(
                f"unexpected stack segments {sorted(set(tree['stack']) - segments)}")

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key not in ("w", "b", "pos_embed", "scale", "bias", "beta", "gamma",
                       "conv_w", "conv_b", "dt_bias", "A_log", "D"):
            raise ValueError(f"unexpected parameter leaf {key!r}")
        arr = np.array(node, dtype=np.float32)  # a writable copy
        dt = dtype if key in _WEIGHTS else torch.float32
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return walk(tree, None)


def cast_weights(params, dtype: torch.dtype):
    """A parameter tree with its weights (the leaves ``params_from_numpy``
    gives the compute dtype) cast to ``dtype``, the rest as they are:
    trained f32 master weights -> the tree ``Engine`` serves."""
    if isinstance(params, dict):
        return {k: (v.to(dtype) if k in _WEIGHTS and not isinstance(v, dict)
                    else cast_weights(v, dtype)) for k, v in params.items()}
    return params


def train_state_from_numpy(state, cfg, device) -> TrainState:
    """The reference's ``TrainState(params, AdamWState(step, m, v),
    error_fb)`` as numpy leaves (``jax.tree.map(np.asarray, state)``) ->
    the port's, on ``device``: params, moments and residual in f32, the
    step an int32 scalar."""
    params, (step, m, v), ef = state
    f32 = lambda t: params_from_numpy(t, cfg, device, torch.float32)
    step = torch.as_tensor(np.array(step, dtype=np.int32), device=device)
    return TrainState(f32(params), AdamWState(step, f32(m), f32(v)),
                      None if ef is None else f32(ef))
