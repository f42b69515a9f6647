"""Llama-3-8B [arXiv:2407.21783]: dense GQA, 128k vocab."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=5e5, act="silu",
)
