"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: mistral-nemo backbone + ViT
frontend (stubbed: input_specs provides precomputed patch embeddings)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6, num_patches=256, act="silu",
)
