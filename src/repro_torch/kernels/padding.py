"""Shared host-side padding helpers for the similarity kernels.

``sim_hist`` and ``sim_sweep`` pad inputs to block multiples and subtract the
padded-pair contributions from their histograms afterwards.  The two
corrections MUST stay bit-identical — the single-sweep stratifier's
fp32 bit-identity guarantee (sweep vs two-pass strata) rests on it — so both
ops import these helpers instead of carrying copies.
"""
from __future__ import annotations

import numpy as np


def pad_rows(e: np.ndarray, mult: int) -> tuple[np.ndarray, int]:
    """Zero-pad rows to a multiple of ``mult``; returns (padded, n_padded)."""
    n = e.shape[0]
    pad = (-n) % mult
    if pad:
        e = np.concatenate([e, np.zeros((pad, e.shape[1]), e.dtype)], axis=0)
    return e, pad


def remove_pad_counts(
    block_counts: np.ndarray,
    scale: np.ndarray,
    p1: int,
    p2: int,
    padded_cols_total: int,
    n_bins: int,
    exponent: float,
    floor: float,
    bm: int,
) -> None:
    """Subtract padded-pair histogram contributions, in place.

    Padded left rows carry scale 0 (weight 0 -> bin 0) across the full
    padded width and always sit in the last row block; real rows pair with
    each padded column at weight ``scale_i * floor**exponent``.
    ``block_counts`` is (n_blocks, n_bins); pass a (1, n_bins) view with
    ``bm >= len(scale)`` for a global histogram.
    """
    if p1:
        block_counts[-1, 0] -= p1 * padded_cols_total
    if p2:
        wpad = scale.astype(np.float64) * (floor**exponent)
        fb = np.clip((wpad * n_bins).astype(np.int64), 0, n_bins - 1)
        np.subtract.at(block_counts, (np.arange(len(scale)) // bm, fb), p2)
