"""Whisper-tiny backbone: enc-dec; conv frontend is a STUB (input_specs
feeds precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=6, d_ff=1536, vocab=51865, enc_dec=True, n_enc_layers=4,
    enc_frames=1500,
)
SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=128, vocab=128, enc_dec=True, n_enc_layers=2,
    enc_frames=32,
)
