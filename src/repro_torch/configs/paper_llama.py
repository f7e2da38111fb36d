"""The paper's own end-to-end model: LLaMA-based, 8 layers, hidden 384,
8 heads (paper IV, Fig. 7a), trained on Wikipedia-1B-shaped data."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-llama", family="dense", n_layers=8, d_model=384, n_heads=8,
    n_kv_heads=8, d_ff=1536, vocab=32000,
)
SMOKE = CONFIG
