"""xLSTM-125M: sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, ssm="xlstm", slstm_every=4,
)
SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", n_layers=4, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=0, vocab=128, ssm="xlstm", slstm_every=2,
)
