"""Reference parameters -> the port's parameters.

The input is the reference ``Model.init`` tree with its ``Param`` leaves
turned into numpy arrays by the caller (the tests do
``jax.tree.map(np.asarray, split_tree(params)[0])``; this module never
imports JAX). Layouts are the same — including the leading ``"stacked"``
layer axis — so the conversion is a tree map that moves each array to the
device: weight matrices and dense biases (``"w"``, ``"b"``) to the compute
dtype, where the reference casts them at every use; norm parameters
(``"scale"``, ``"bias"``) stay f32, as the reference reads them.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, cfg, device, dtype: torch.dtype = torch.bfloat16):
    """Nested dict of numpy arrays (reference layout) -> nested dict of
    tensors on ``device`` for ``repro_torch.models.model.Model(cfg, dtype)``.
    Raises on a subtree the dense port does not know (e.g. learnable
    softmax parameters ``"smx"``)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} parameters are not ported: ROADMAP.md Queue 1 item 11")

    def walk(node, key):
        if isinstance(node, dict):
            if "smx" in node:
                raise NotImplementedError(
                    "learnable softmax parameters are not ported: ROADMAP.md "
                    "Queue 1 item 12")
            return {k: walk(v, k) for k, v in node.items()}
        if key not in ("w", "b", "scale", "bias"):
            raise ValueError(f"unexpected parameter leaf {key!r}")
        arr = np.array(node, dtype=np.float32)  # a writable copy
        dt = torch.float32 if key in ("scale", "bias") else dtype
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return walk(tree, None)
