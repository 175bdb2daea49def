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
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, cfg, device, dtype: torch.dtype = torch.bfloat16):
    """Nested dict of numpy arrays (reference layout) -> nested dict of
    tensors on ``device`` for ``repro_torch.models.model.Model(cfg, dtype)``.
    Raises on a leaf or a stack segment the port does not know."""
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
        dt = dtype if key in ("w", "b", "pos_embed") else torch.float32
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return walk(tree, None)
