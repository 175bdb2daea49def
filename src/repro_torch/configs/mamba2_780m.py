"""Mamba2-780M: attention-free SSD stack  [arXiv:2405.21060].

SoftmAP inapplicability: no softmax in the token-mixing path, so no
attention kernel runs and the AP meter reads zero. Decode state is O(1) in
context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, ssm_groups=1, ssm_conv=4, ssm_chunk=256,
    norm="rmsnorm", rope_type="none", max_seq=1 << 20,
)
