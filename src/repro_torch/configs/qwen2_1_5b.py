"""Qwen2-1.5B [arXiv:2407.10671]: dense GQA decoder with QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, tied_embeddings=True, act="silu",
)
