"""Qwen3-32B: dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab=151936, qk_norm=True,
)
SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab=128, qk_norm=True,
)
