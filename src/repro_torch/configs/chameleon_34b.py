"""Chameleon-34B: early-fusion VLM — VQ image tokens are ordinary vocab
entries, so the backbone is a dense GQA transformer with qk-norm
[arXiv:2405.09818]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
)
SMOKE = ModelConfig(
    name="chameleon-smoke", family="vlm", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab=128, qk_norm=True,
)
