"""Precision contract for exporting the embedder's record embeddings into the
similarity kernels.  The embedder itself (a MiniLM-scale encoder, width 384)
comes with the model stack; only the precision table is needed by the query
engine."""
import dataclasses


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
