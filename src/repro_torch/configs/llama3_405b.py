"""Llama-3 405B: dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
)
SMOKE = ModelConfig(
    name="llama3-smoke", family="dense", n_layers=4, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=384, vocab=256,
)
