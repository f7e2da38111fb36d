"""Minitron-4B: pruned Nemotron dense GQA [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=9216, vocab=256000,
)
SMOKE = ModelConfig(
    name="minitron-smoke", family="dense", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab=128,
)
