"""RWKV6 (Finch) 1.6B [arXiv:2404.05892]: attention-free, data-dependent decay."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0, head_dim=64,
    d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64, rwkv_decay_lora=64, act="silu",
)
