"""DeepSeek-7B: dense llama-arch (MHA)  [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_head=128, d_ff=11008, vocab=102400,
    norm="rmsnorm", act="silu", rope_theta=10000.0, max_seq=32768,
)
