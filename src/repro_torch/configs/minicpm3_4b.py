"""MiniCPM3-4B: dense with MLA  [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560, n_heads=40,
    n_kv_heads=40, d_head=96, d_ff=6400, vocab=73448, attention="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64, norm="rmsnorm", act="silu", max_seq=32768,
)
