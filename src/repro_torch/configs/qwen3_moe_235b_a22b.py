"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128-expert top-8 MoE."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8, rope_theta=1e6, act="silu",
)
