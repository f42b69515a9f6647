"""Whisper-medium [arXiv:2212.04356]: encoder-decoder; conv frontend stubbed —
input_specs provides precomputed (B, 1500, d) frame embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_seq=1500, act="gelu_mlp",
)
