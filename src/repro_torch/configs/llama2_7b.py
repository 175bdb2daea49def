"""Llama2-7B: the paper's own evaluation model  [arXiv:2307.09288]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=32, d_head=128, d_ff=11008, vocab=32000,
    norm="rmsnorm", act="silu", rope_theta=10000.0, max_seq=4096,
)
