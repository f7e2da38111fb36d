"""DeepSeek-Coder-33B: llama-arch dense GQA [arXiv:2401.14196]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256,
)
SMOKE = ModelConfig(
    name="dscoder-smoke", family="dense", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab=128,
)
