"""Architecture registry: ``--arch <id>`` resolution + reduced smoke presets
(port of ``src/repro/configs/registry.py``; same configs, same shrink
rules). Every reference architecture is registered.

qwen2.5-32b (64 layers, 32.76 B parameters: 65.5 GB of bf16 weights) fits
the H100's 80 GB with about 18 GiB left for its pool, so it serves on one
card, single-device or tensor-parallel with its shards on that card. The
MoE family's full depth does not fit one card: dbrx-132b's 40 layers are
about 264 GB of bf16 weights and deepseek-v2-236b's 60 about 472 GB, so on
the H100 both run at full width with their depth cut (``get_config(name,
n_layers=4)``), single-device or with their experts split over shards on
that card; full depth waits for a process per card (ROADMAP.md Queue 1
item 21). The SSM and hybrid families (mamba2-780m, hymba-1.5b), the
encoder-decoder (whisper-base) and the M-RoPE backbone (qwen2-vl-7b) run
at full width and full depth."""

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
    "deepseek-7b": "deepseek_7b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-780m": "mamba2_780m",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-base": "whisper_base",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen2.5-32b": "qwen2_5_32b",
}


def get_config(name: str, softmax: Optional[SoftmaxSpec] = None,
               **overrides) -> ModelConfig:
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
    (dense, MoE, SSM, hybrid and encoder-decoder; GQA or MLA attention;
    M-RoPE's sections cut to the smoke head width)."""
    full = get_config(name)
    shrink: Dict = dict(
        n_layers=6 if full.family == "hybrid" else min(full.n_layers, 3),
        d_model=128, d_head=32, vocab=512, max_seq=128, attn_chunk=32,
        rope_theta=full.rope_theta,
    )
    if full.uses_attention:
        shrink["n_heads"] = 4
        shrink["n_kv_heads"] = min(4, max(1, full.n_kv_heads * 4 // full.n_heads))
    if full.rope_type == "mrope":
        shrink["mrope_sections"] = (4, 6, 6)  # d_head 32 -> 16 half-dims
    if full.family != "ssm":
        shrink["d_ff"] = 256
    if full.attention == "mla":
        shrink.update(q_lora_rank=(64 if full.q_lora_rank else 0),
                      kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                      v_head_dim=32, d_head=48)
    if full.family == "moe":
        shrink.update(n_experts=4, moe_top_k=min(2, full.moe_top_k),
                      d_ff_expert=128, d_ff=256,
                      n_shared_experts=min(1, full.n_shared_experts))
    if full.family in ("ssm", "hybrid"):
        shrink.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32, window=32)
    cfg = dataclasses.replace(full, name=full.name + "-smoke", **shrink)
    if softmax is not None:
        cfg = cfg.with_softmax(softmax)
    return cfg
