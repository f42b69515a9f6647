"""The pair prompt and the scorer's batches, worked out from the records.

A record pair is served as ``[BOS] r1 [SEP] r2 [SCORE]`` in byte tokens
(byte b is token b + 8; each record cut to ``max_len // 2 - 3`` bytes),
and P(match) is read at the last position.  A request's pairs are grouped
by the smallest power-of-two length from ``min_bucket`` (or ``max_len``)
that holds the prompt, in ascending length, each group cut into batches of
``batch`` rows in request order, the last one filled with all-pad rows:
the batch is part of the computation, since an expert's capacity is shared
by every token of it.
"""
from __future__ import annotations

import numpy as np

PAD, BOS, SEP, SCORE, YES, NO = 0, 1, 3, 4, 5, 6
N_SPECIAL = 8


def prompt(r1: str, r2: str, max_len: int) -> np.ndarray:
    cut = max_len // 2 - 3
    enc = [np.frombuffer(r.encode(), np.uint8)[:cut].astype(np.int64) + N_SPECIAL
           for r in (r1, r2)]
    ids = np.concatenate([[BOS], enc[0], [SEP], enc[1], [SCORE]]).astype(np.int64)
    return ids[:max_len]


def prompt_lengths(pairs: np.ndarray, left: list, right: list, max_len: int) -> np.ndarray:
    cut = max_len // 2 - 3
    n1 = np.array([min(len(r.encode()), cut) for r in left])
    n2 = np.array([min(len(r.encode()), cut) for r in right])
    pairs = np.asarray(pairs)
    return np.minimum(n1[pairs[:, 0]] + n2[pairs[:, 1]] + 3, max_len)


def buckets(max_len: int, min_bucket: int = 16) -> np.ndarray:
    out, b = [], max(min(min_bucket, max_len), 1)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return np.array(out, np.int64)


def batches(pairs: np.ndarray, left: list, right: list, max_len: int, batch: int,
            min_bucket: int = 16) -> list:
    """[(rows, tokens (batch, L) int64, last (batch,) int64)] in the order the
    scorer runs them; ``rows`` index ``pairs``."""
    seqs = [prompt(left[p[0]], right[p[1]], max_len) for p in np.asarray(pairs)]
    lens = np.array([len(s) for s in seqs], np.int64)
    bk = buckets(max_len, min_bucket)
    pad_of = bk[np.searchsorted(bk, lens)]
    out = []
    for pad_len in np.unique(pad_of):
        sel = np.nonzero(pad_of == pad_len)[0]
        for s in range(0, len(sel), batch):
            rows = sel[s:s + batch]
            toks = np.zeros((batch, int(pad_len)), np.int64)
            last = np.zeros(batch, np.int64)
            for r, i in enumerate(rows):
                toks[r, :lens[i]] = seqs[i]
                last[r] = lens[i] - 1
            out.append((rows, toks, last))
    return out
