"""Model / run configuration (a copy of ``src/repro/configs/base.py``).

One ``ModelConfig`` covers every architecture family of the reference, so
configs compare field for field across the two packages; the port runs the
dense family so far (``configs/registry.py`` names what is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.softmax_variants import SoftmaxSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 4096

    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np (OLMo)
    act: str = "silu"              # silu | gelu
    qkv_bias: bool = False         # Qwen2-style QKV bias
    tie_embeddings: bool = False
    attention: str = "gqa"         # gqa | mla
    rope_type: str = "rope"        # none | rope | mrope
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t/h/w split of d_head//2

    # --- MLA (MiniCPM3 / DeepSeek-V2) ---
    q_lora_rank: int = 0           # 0 -> no q compression
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- MoE (DBRX / DeepSeek-V2) ---
    n_experts: int = 0
    moe_top_k: int = 4
    n_shared_experts: int = 0
    d_ff_expert: int = 0           # per-expert hidden dim
    capacity_factor: float = 1.25
    n_dense_prefix: int = 0        # first-k layers use a dense FFN (DeepSeek-V2: 1)
    router_aux_weight: float = 0.01
    moe_impl: str = "gather"       # gather | scatter_combine | expert_tp | a2a
    moe_a2a_segments: int = 16     # token segments for the a2a dispatch

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Hymba): parallel attn+SSM heads; sliding window elsewhere ---
    window: int = 1024             # sliding-window size for window layers
    full_attn_every: int = 0       # 0 -> hymba rule (first/middle/last full)

    # --- enc-dec (Whisper): n_layers encoder + n_layers decoder ---
    frontend_dim: int = 0          # stub frontend: precomputed frame/patch embeds

    # --- softmax plug (the paper's technique) ---
    softmax: SoftmaxSpec = SoftmaxSpec("fp")

    # --- execution ---
    remat: str = "full"            # none | full | dots
    scan_layers: bool = True
    attn_chunk: int = 2048         # q-block chunk size; 0 -> unchunked
    logits_dtype: str = "float32"
    scores_dtype: str = "float32"  # attention score storage (bf16 = low-mem)
    kv_quant: bool = False         # int8 KV cache (per-position/head scales)
    kv_quant_scheme: str = "absmax"  # absmax | exaq (EXAQ pow2 scales,
                                     # 2410.03185) | exaq_clamped (5-bit exp)

    # --- sharding rule overrides (logical axis -> mesh axes), see distributed/sharding.py
    sharding_overrides: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = ()

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.family == "moe" and self.d_ff_expert == 0:
            object.__setattr__(self, "d_ff_expert", self.d_ff)
        if self.n_kv_heads == 0:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec"), self.family
        assert self.kv_quant_scheme in ("absmax", "exaq", "exaq_clamped"), \
            self.kv_quant_scheme
        if self.family != "ssm":
            assert self.n_heads % max(self.n_kv_heads, 1) == 0

    # ---- derived ----

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k+ contexts (SSM state / sliding window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, V, L = self.d_model, self.vocab, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            g = self.ssm_groups
            blk = (d * (2 * di + 2 * g * ns + nh)      # in_proj
                   + self.ssm_conv * (di + 2 * g * ns)  # conv
                   + nh * 2                              # A, D
                   + di                                  # gate norm
                   + di * d)                             # out_proj
            return emb + L * (blk + d)
        if self.attention == "mla":
            attn = (d * self.q_lora_rank if self.q_lora_rank else 0)
            qdim = self.q_lora_rank if self.q_lora_rank else d
            attn += qdim * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            attn += d * (self.kv_lora_rank + self.qk_rope_dim)
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            attn += self.n_heads * self.d_head * d
        ffn_dense = 3 * d * self.d_ff
        if self.family == "moe":
            ffn_moe = self.n_experts * 3 * d * self.d_ff_expert
            ffn_moe += self.n_shared_experts * 3 * d * self.d_ff_expert
            ffn_moe += d * self.n_experts  # router
            n_moe = L - self.n_dense_prefix
            ffn_total = self.n_dense_prefix * ffn_dense + n_moe * ffn_moe
            per_layer_rest = attn + 2 * d
            total = emb + L * per_layer_rest + ffn_total
        elif self.family == "hybrid":
            di = self.d_inner
            ssm = d * (2 * di + 2 * self.ssm_groups * self.ssm_state + self.ssm_nheads)
            ssm += di * d + di
            total = emb + L * (attn + ssm + ffn_dense + 2 * d)
        elif self.family == "encdec":
            total = emb + 2 * L * (attn + ffn_dense + 2 * d) + L * attn
        else:
            total = emb + L * (attn + ffn_dense + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (differs from total only for MoE)."""
        if self.family != "moe":
            return self.param_count()
        dense_like = dataclasses.replace(
            self, family="dense", n_experts=0,
            d_ff=self.d_ff_expert * (self.moe_top_k + self.n_shared_experts))
        return dense_like.param_count()

    def flops_per_token_train(self, seq_len: int) -> float:
        """~6*N_active*D plus attention quadratic term."""
        base = 6.0 * self.active_param_count()
        if self.uses_attention:
            # fwd 2*2*L*S*d_attn per token, x3 for bwd
            d_attn = self.n_heads * self.d_head
            base += 12.0 * self.n_layers * seq_len * d_attn
        return base

    def with_softmax(self, spec: SoftmaxSpec) -> "ModelConfig":
        return dataclasses.replace(self, softmax=spec)
