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
