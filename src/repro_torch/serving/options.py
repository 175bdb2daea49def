"""ServeOptions — the configuration surface of ``Engine.serve`` (a copy of
``src/repro/serving/options.py``: same field names, defaults and
cross-field checks).

    from repro_torch.serving.options import ServeOptions
    rep = engine.serve(reqs, options=ServeOptions(paged=True,
                                                  prefix_share=True,
                                                  kernel="pallas"))

Every option of the reference is ported; ``mesh`` / ``shards`` serve
tensor-parallel (``serving/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

#: serve policies the scheduler understands (see scheduler.SlotScheduler)
POLICIES = ("continuous", "gang")
#: decode kernels: "jnp" gathers then attends, "pallas" runs the fused
#: paged-decode kernel (K2, or K4 for MLA); the names are the reference's
KERNELS = ("jnp", "pallas")


@dataclasses.dataclass
class ServeOptions:
    """Everything ``Engine.serve`` accepts besides the request trace."""

    # -- batching geometry --
    slots: int = 4
    cache_len: Optional[int] = None
    policy: str = "continuous"
    report_cost: bool = False
    # -- paged pool / prefix sharing --
    paged: bool = False
    block_size: int = 16
    num_blocks: Optional[int] = None
    prefix_share: bool = False
    # -- speculative decoding --
    speculative: bool = False
    draft_k: int = 4
    draft: str = "ngram"
    max_ngram: int = 3
    draft_model: Any = None
    draft_params: Any = None
    # -- execution backend --
    kernel: str = "jnp"
    mesh: Any = None
    shards: Optional[int] = None
    # -- softmax variant --
    # registry backend name overriding the model's softmax for THIS serve
    # call (the variant shares the engine's params); None = the model's own
    softmax_kind: Optional[str] = None
    # -- SLA scheduling --
    prefill_chunk: Optional[int] = None
    preemption: bool = False
    aging: float = 16.0
    hol_grace: float = 32.0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.prefix_share and not self.paged:
            raise ValueError("prefix_share=True requires paged=True")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.preemption and not self.paged:
            raise ValueError("preemption=True requires paged=True (swap-out "
                             "releases pool blocks through the allocator)")
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown decode kernel {self.kernel!r} "
                             f"(expected jnp | pallas)")
        if self.kernel != "jnp" and not self.paged:
            raise ValueError("kernel='pallas' requires paged=True (the "
                             "fused kernel walks the block table)")
        if self.shards is not None and self.mesh is not None:
            raise ValueError("pass either shards=N or mesh=..., not both")
        if self.softmax_kind is not None:
            from repro_torch.backends.registry import settled_backend_names
            names = settled_backend_names()
            if names is not None and self.softmax_kind not in names:
                raise ValueError(
                    f"unknown softmax_kind {self.softmax_kind!r}; registered "
                    f"backends: {', '.join(names)}")
