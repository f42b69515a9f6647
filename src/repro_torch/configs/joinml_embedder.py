"""The paper's embedding model: a small encoder-style LM whose mean-pooled
hidden state is the record embedding (MiniLM-scale), plus the precision
contract for exporting those embeddings into the similarity kernels."""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="joinml-embedder", family="dense",
    num_layers=6, d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=32768, tied_embeddings=True, causal=False, act="silu",
)


@dataclasses.dataclass(frozen=True)
class EmbeddingPrecision:
    """How embeddings enter the similarity sweep (``kernels/sim_sweep``).

    ``max_cdf_shift`` is the documented tolerance: the largest sup-distance
    between the low-precision and fp32 weight-histogram CDFs the
    stratifier accepts before falling back to fp32 (0.0 means exact — no
    check needed)."""

    name: str
    dtype: str            # on-wire dtype of the exported embeddings
    per_row_scale: bool   # True when a (N, 1) f32 dequant scale rides along
    max_cdf_shift: float


# Export targets for the sweep's precision fast path.  fp32 is the exact
# default; bf16 feeds the kernel bf16-rounded inputs with f32 accumulation;
# int8 ships per-row symmetric quantisation (see
# ``repro_torch.core.similarity.quantize_rows_int8``) with int32
# accumulation.
EMBEDDING_PRECISIONS = {
    "fp32": EmbeddingPrecision("fp32", "float32", False, 0.0),
    "bf16": EmbeddingPrecision("bf16", "bfloat16", False, 0.02),
    "int8": EmbeddingPrecision("int8", "int8", True, 0.02),
}
