"""Host data pipeline for Oracle serving (numpy; a copy of the reference's
``data/pipeline.py``).

* :class:`ByteTokenizer` — reversible byte-level tokenizer with specials.
* :func:`make_entity_corpus` — synthetic record corpus with latent entities
  (noisy string variants), the learnable analog of the paper's EM datasets:
  the Oracle LM is trained to answer whether two records denote one entity.
* :func:`pair_example` — serializes a record pair into the pair-scoring
  prompt  ``[BOS] r1 [SEP] r2 [SCORE] -> {YES|NO}`` (Narayan et al. style).
* :func:`make_pair_batch` — a balanced labelled pair batch.

The reference's ``ShardedLoader`` comes with training (ROADMAP queue 1,
item 11).
"""
from __future__ import annotations

import string
from typing import Optional

import numpy as np


class ByteTokenizer:
    PAD, BOS, EOS, SEP, SCORE, YES, NO = 0, 1, 2, 3, 4, 5, 6
    N_SPECIAL = 8

    @property
    def vocab_size(self) -> int:
        return 256 + self.N_SPECIAL

    def encode(self, text: str) -> list:
        return [b + self.N_SPECIAL for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        return bytes(
            int(i) - self.N_SPECIAL for i in ids if int(i) >= self.N_SPECIAL
        ).decode("utf-8", errors="replace")


_WORDS = (
    "data systems corp labs global tech media group solutions net "
    "works dynamics micro quantum logic apex vertex nova prime delta"
).split()


def make_entity_corpus(
    n_entities: int = 64,
    records_per_entity: int = 4,
    noise: float = 0.1,
    seed: int = 0,
) -> tuple[list, np.ndarray]:
    """Returns (records, entity_ids): noisy string variants per entity."""
    rng = np.random.default_rng(seed)
    records, ids = [], []
    for e in range(n_entities):
        base = " ".join(rng.choice(_WORDS, size=3)) + f" {e % 97}"
        for _ in range(records_per_entity):
            chars = list(base)
            for i in range(len(chars)):
                if rng.random() < noise:
                    chars[i] = rng.choice(list(string.ascii_lowercase))
            records.append("".join(chars))
            ids.append(e)
    return records, np.array(ids)


def pair_example(
    tok: ByteTokenizer, r1: str, r2: str, label: Optional[int], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (tokens, loss_mask).  Label token is the final position."""
    ids = (
        [tok.BOS]
        + tok.encode(r1)[: max_len // 2 - 3]
        + [tok.SEP]
        + tok.encode(r2)[: max_len // 2 - 3]
        + [tok.SCORE]
    )
    mask = [0.0] * len(ids)
    if label is not None:
        ids.append(tok.YES if label else tok.NO)
        mask.append(1.0)
    ids = ids[:max_len]
    mask = mask[:max_len]
    pad = max_len - len(ids)
    return (
        np.array(ids + [tok.PAD] * pad, np.int32),
        np.array(mask + [0.0] * pad, np.float32),
    )


def make_pair_batch(
    tok: ByteTokenizer,
    records: list,
    entity_ids: np.ndarray,
    batch: int,
    max_len: int,
    rng: np.random.Generator,
    positive_fraction: float = 0.5,
):
    """Balanced labelled pair batch for Oracle training."""
    n = len(records)
    by_entity: dict = {}
    for i, e in enumerate(entity_ids):
        by_entity.setdefault(int(e), []).append(i)
    multi = [e for e, v in by_entity.items() if len(v) >= 2]
    toks = np.zeros((batch, max_len), np.int32)
    masks = np.zeros((batch, max_len), np.float32)
    labels = np.zeros((batch,), np.int32)
    for b in range(batch):
        if rng.random() < positive_fraction and multi:
            e = multi[rng.integers(len(multi))]
            i, j = rng.choice(by_entity[e], size=2, replace=False)
            label = 1
        else:
            i, j = rng.integers(n), rng.integers(n)
            label = int(entity_ids[i] == entity_ids[j])
        toks[b], masks[b] = pair_example(tok, records[i], records[j], label, max_len)
        labels[b] = label
    return {"tokens": toks, "loss_mask": masks, "labels": labels}
