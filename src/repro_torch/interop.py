"""Carrying state across from the reference package.

The query engine has no weights; its state is the tables and the
configuration.  These helpers take what the reference hands out as plain
data — ``dataclasses.asdict(BASConfig())`` and numpy embeddings — and build
the port's objects, so a test can feed both packages the same thing."""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.types import BASConfig, JoinSpec


def bas_config_from_dict(d: dict) -> BASConfig:
    """A :class:`BASConfig` from the reference's ``asdict`` output.  Unknown
    keys raise, so a field added on one side cannot be dropped silently."""
    names = {f.name for f in dataclasses.fields(BASConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown BASConfig fields: {sorted(unknown)}")
    return BASConfig(**d)


def spec_from_arrays(embeddings: list) -> JoinSpec:
    """A :class:`JoinSpec` over float32 copies of numpy embeddings."""
    return JoinSpec(embeddings=[np.asarray(e, np.float32) for e in embeddings])
