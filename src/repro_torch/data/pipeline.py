"""Host data pipeline for Oracle serving (numpy; a copy of the reference's
``data/pipeline.py``).

* :class:`ByteTokenizer` — reversible byte-level tokenizer with specials.
* :func:`make_entity_corpus` — synthetic record corpus with latent entities
  (noisy string variants), the learnable analog of the paper's EM datasets:
  the Oracle LM is trained to answer whether two records denote one entity.
* :func:`pair_example` — serializes a record pair into the pair-scoring
  prompt  ``[BOS] r1 [SEP] r2 [SCORE] -> {YES|NO}`` (Narayan et al. style).
* :func:`make_pair_batch` — a balanced labelled pair batch.
* :class:`ShardedLoader` — the deterministic, restartable, host-sharded
  training loader with prefetch, and :func:`tree_slice` (the reference's
  ``jax_tree_slice`` on numpy trees).
"""
from __future__ import annotations

import queue
import string
import threading
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


class ShardedLoader:
    """Deterministic, restartable, host-sharded loader with prefetch.

    ``batch_fn(rng) -> dict of np arrays (global_batch, ...)``; the batch of
    step s comes from ``np.random.default_rng(SeedSequence([seed, s]))``, so
    a restart at step s replays the stream, and each host slices its
    contiguous shard [host_id * per_host : (host_id+1) * per_host].  The
    prefetch thread starts here and stops at :meth:`close`.
    """

    def __init__(
        self,
        batch_fn,
        global_batch: int,
        num_hosts: int = 1,
        host_id: int = 0,
        seed: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        if global_batch % num_hosts:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{num_hosts} hosts")
        self.batch_fn = batch_fn
        self.per_host = global_batch // num_hosts
        self.host_id = host_id
        self.seed = seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _make(self, step: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        full = self.batch_fn(rng)
        lo = self.host_id * self.per_host
        return tree_slice(full, lo, lo + self.per_host)

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self, timeout: float = 5.0):
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout)


def tree_slice(tree, lo, hi):
    """Rows [lo, hi) of every array of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_slice(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_slice(v, lo, hi) for v in tree)
    return tree[lo:hi]
