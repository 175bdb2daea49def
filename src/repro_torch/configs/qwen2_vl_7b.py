"""Qwen2-VL-7B backbone: M-RoPE, dynamic-resolution vision frontend STUBBED
(input_specs provides patch embeddings + 3-stream positions)  [arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="dense", n_layers=28, d_model=3584, n_heads=28,
    n_kv_heads=4, d_head=128, d_ff=18944, vocab=152064, qkv_bias=True,
    rope_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    norm="rmsnorm", act="silu", max_seq=32768,
)
