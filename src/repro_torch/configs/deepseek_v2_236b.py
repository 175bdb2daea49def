"""DeepSeek-V2-236B: MLA (kv_lora 512) + 160-expert top-6 MoE, 2 shared experts,
one dense-FFN prefix layer  [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_head=192, d_ff=12288, vocab=102400,
    attention="mla", q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128, n_experts=160, moe_top_k=6,
    n_shared_experts=2, d_ff_expert=1536, n_dense_prefix=1,
    norm="rmsnorm", act="silu", max_seq=32768,
)
