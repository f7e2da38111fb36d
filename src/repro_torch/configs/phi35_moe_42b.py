"""Phi-3.5-MoE 42B (6.6B active): 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064, moe=True,
    n_experts=16, top_k=2, moe_d_ff=6400,
)
SMOKE = ModelConfig(
    name="phi35-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128, moe=True, n_experts=4, top_k=2,
    moe_d_ff=128,
)
