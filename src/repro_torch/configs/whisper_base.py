"""Whisper-base: encoder-decoder, conv/audio frontend STUBBED (input_specs
provides precomputed frame embeddings)  [arXiv:2212.04356].

Sharding override: 8 heads on a 16-way model axis would halve-idle the TP
group; attention stays replicated (the model is tiny), FFN/vocab keep TP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512, n_heads=8,
    n_kv_heads=8, d_head=64, d_ff=2048, vocab=51865, tie_embeddings=True,
    norm="layernorm", act="gelu", rope_type="none", max_seq=32768,
    sharding_overrides=(("heads", None), ("kv_heads", None)),
)
