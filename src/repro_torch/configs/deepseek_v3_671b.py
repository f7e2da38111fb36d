"""DeepSeek-V3 671B: MLA, 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280, moe=True,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, head_dim=128, mtp=True,
)
SMOKE = ModelConfig(
    name="dsv3-smoke", family="moe", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=128, moe=True, n_experts=8,
    n_shared_experts=1, top_k=2, moe_d_ff=64, first_dense_layers=1,
    mla=True, q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, head_dim=16,
    mtp=True,
)
