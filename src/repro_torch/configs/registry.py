"""Architecture registry: ``--arch <id>`` resolution + reduced smoke presets
(port of ``src/repro/configs/registry.py``; same configs, same shrink
rules). An architecture whose family the port does not run yet raises and
names its ROADMAP.md item."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.softmax_variants import SoftmaxSpec

ARCHS = {
    "olmo-1b": "olmo_1b",
    "minicpm3-4b": "minicpm3_4b",
    "llama2-7b": "llama2_7b",
}

# reference architectures not ported yet -> the ROADMAP.md item that ports them
NOT_PORTED = {
    "qwen2.5-32b": "Queue 1 item 14 (tensor-parallel serving: 32B does not "
                   "fit one card)",
    "deepseek-7b": "Queue 1 item 15 (a config copy and its parity test: "
                   "the dense llama-arch MHA family it runs is ported)",
    "mamba2-780m": "Queue 1 item 11 (SSM)",
    "dbrx-132b": "Queue 1 item 11 (MoE)",
    "deepseek-v2-236b": "Queue 1 items 11 (MoE) and 14 (tensor-parallel "
                        "serving: 236B does not fit one card)",
    "hymba-1.5b": "Queue 1 item 11 (hybrid)",
    "whisper-base": "Queue 1 item 11 (encdec)",
    "qwen2-vl-7b": "Queue 1 item 11 (M-RoPE)",
}


def get_config(name: str, softmax: Optional[SoftmaxSpec] = None,
               **overrides) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: ROADMAP.md "
            f"{NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    cfg: ModelConfig = mod.CONFIG
    if softmax is not None:
        cfg = cfg.with_softmax(softmax)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def smoke_config(name: str, softmax: Optional[SoftmaxSpec] = None) -> ModelConfig:
    """Reduced config of the same family: small widths/layers/vocab,
    runnable on CPU. The reference's shrink rules for the ported families
    (dense GQA and dense MLA)."""
    full = get_config(name)
    shrink: Dict = dict(
        n_layers=min(full.n_layers, 3),
        d_model=128, d_head=32, vocab=512, max_seq=128, attn_chunk=32,
        rope_theta=full.rope_theta, n_heads=4,
        n_kv_heads=min(4, max(1, full.n_kv_heads * 4 // full.n_heads)),
        d_ff=256,
    )
    if full.attention == "mla":
        shrink.update(q_lora_rank=(64 if full.q_lora_rank else 0),
                      kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                      v_head_dim=32, d_head=48)
    cfg = dataclasses.replace(full, name=full.name + "-smoke", **shrink)
    if softmax is not None:
        cfg = cfg.with_softmax(softmax)
    return cfg
