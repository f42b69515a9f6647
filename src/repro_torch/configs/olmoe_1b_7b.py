"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE (kv=16 -> MHA)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    num_experts=64, num_experts_per_tok=8, act="silu",
)
