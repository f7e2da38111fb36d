"""Zamba2-7B: Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab=32000, ssm="mamba2", ssm_state=64,
    attn_every=6,
)
SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", n_layers=7, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=256, vocab=128, ssm="mamba2", ssm_state=16,
    attn_every=3,
)
