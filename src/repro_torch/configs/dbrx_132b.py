"""DBRX-132B: 16-expert top-4 fine-grained MoE, GQA  [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_head=128, d_ff=10752, vocab=100352, n_experts=16,
    moe_top_k=4, d_ff_expert=10752, norm="layernorm", act="silu",
    rope_theta=500000.0, max_seq=32768,
)
