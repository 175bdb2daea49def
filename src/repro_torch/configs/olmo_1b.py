"""OLMo-1B: dense, non-parametric LayerNorm, tied embeddings  [arXiv:2402.00838]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=8192, vocab=50304, tie_embeddings=True,
    norm="layernorm_np", act="silu", rope_theta=10000.0, max_seq=32768,
)
