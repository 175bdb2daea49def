"""Qwen2.5-32B: dense GQA, QKV bias  [hf:Qwen/Qwen2.5-* family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv_heads=8, d_head=128, d_ff=27648, vocab=152064, qkv_bias=True,
    norm="rmsnorm", act="silu", rope_theta=1_000_000.0, max_seq=32768,
)
