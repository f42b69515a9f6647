"""Persistence of the port's host-side artifacts: the stratification index
(:mod:`repro_torch.checkpoint.index_io`) and the shared label store's
segments (:mod:`repro_torch.checkpoint.label_io`).  Both lay their files out
as the reference package does, so either package loads what the other
saved."""
from .label_io import (  # noqa: F401
    LABEL_STORE_FORMAT,
    canonical_key,
    load_segments,
    save_segment,
    segment_digest,
)
