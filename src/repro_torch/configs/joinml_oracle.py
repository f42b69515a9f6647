"""The paper's Oracle as a small pair-scoring LM (~100M): scores whether two
serialized records satisfy the join condition (entity-match prompt style)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="joinml-oracle", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=32768, tied_embeddings=True, act="silu",
)
