"""Model configuration dataclass (copy of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False        # qwen3 / chameleon
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden (d_ff is the dense-layer hidden)
    first_dense_layers: int = 0  # deepseek-v3 keeps first layers dense
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    mtp: bool = False            # multi-token-prediction auxiliary head
    # --- SSM / hybrid ---
    ssm: str = ""                # "" | "mamba2" | "xlstm"
    ssm_state: int = 0
    attn_every: int = 0          # hybrid: one (shared) attention block every k layers
    slstm_every: int = 0         # xlstm: sLSTM block every k layers (rest mLSTM)
    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500       # stub frontend sequence length
    # --- misc ---
    rope_theta: float = 500000.0
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate total parameters (for roofline MODEL_FLOPS)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.ssm == "xlstm":
            per = 8 * d * d  # qkv+gates+out and up/down projections
            return emb + L * per
        attn = d * (self.n_heads * self.hd) * 2 + d * (self.n_kv_heads * self.hd) * 2
        if self.mla:
            attn = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (self.hd + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * self.hd * 2
                    + self.n_heads * self.hd * d)
        dense_ff = 3 * d * self.d_ff
        if self.moe:
            moe_ff = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            n_moe = L - self.first_dense_layers
            ff_total = self.first_dense_layers * dense_ff + n_moe * moe_ff
        else:
            ff_total = L * dense_ff
        if self.ssm == "mamba2":
            n_attn = L // self.attn_every if self.attn_every else 0
            n_ssm = L - n_attn
            per_ssm = 2 * d * 2 * d + 2 * d * d  # in-proj (x,z) + out-proj, ~Mamba2
            return emb + n_ssm * per_ssm + n_attn * (attn + dense_ff) + ff_total * 0
        return emb + L * attn + ff_total
