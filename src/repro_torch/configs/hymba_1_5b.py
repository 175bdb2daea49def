"""Hymba-1.5B: parallel attention + SSM heads; sliding-window attention
except layers {first, middle, last}  [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600, n_heads=25,
    n_kv_heads=5, d_head=64, d_ff=5504, vocab=32001, ssm_state=16,
    ssm_expand=2, ssm_head_dim=64, ssm_chunk=256, window=1024,
    norm="rmsnorm", act="silu", max_seq=1 << 20,
)
