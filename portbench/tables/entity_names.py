"""Short name records of latent entities, with character noise (the recipe
of the port's ``data/pipeline.make_entity_corpus``), embedded as hashed
byte-trigram rows (as ``chip_smoke.trigram_embeddings`` does).

``spec``: ``entities``, ``records_per_entity`` (even-numbered records of an
entity go left, odd-numbered ones right), ``noise`` (the chance a character
is replaced by a random letter), ``d`` (the embedding width),
``corpus_seed``.

The corpus is drawn from ``corpus_seed``, part of the configuration, and
the run's seed puts each side's records in an order of its own: every seed
joins the same records, so every seed does the same work.
"""
from __future__ import annotations

import numpy as np

from harness.common import Tables, rng

WORDS = ("data systems corp labs global tech media group solutions net "
         "works dynamics micro quantum logic apex vertex nova prime delta").split()
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def corpus(n_entities: int, per_entity: int, noise: float, gen) -> tuple:
    records, ids = [], []
    for e in range(n_entities):
        base = " ".join(gen.choice(WORDS, size=3)) + f" {e % 97}"
        raw = np.frombuffer(base.encode(), np.uint8)
        for _ in range(per_entity):
            hit = gen.random(len(raw)) < noise
            chars = np.where(hit, LETTERS[gen.integers(0, 26, len(raw))], raw)
            records.append(chars.tobytes().decode())
            ids.append(e)
    return records, np.array(ids, np.int64)


def trigram_embeddings(records: list, d: int) -> np.ndarray:
    """Unit rows of byte-trigram counts, each trigram hashed to one of ``d``
    columns by a fixed multiplicative hash."""
    out = np.zeros((len(records), d), np.float32)
    for i, r in enumerate(records):
        b = np.frombuffer(f"  {r} ".encode(), np.uint8).astype(np.uint64)
        key = (b[:-2] << np.uint64(16)) | (b[1:-1] << np.uint64(8)) | b[2:]
        col = ((key * np.uint64(2654435761)) % np.uint64(2**32)) % np.uint64(d)
        np.add.at(out[i], col.astype(np.int64), 1.0)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def make(spec: dict, seed: int, device) -> Tables:
    records, ids = corpus(int(spec["entities"]), int(spec["records_per_entity"]),
                          float(spec["noise"]), rng(spec["corpus_seed"], "entity_names"))
    order = rng(seed, "order")
    sides, side_ids = [], []
    for half in (slice(0, None, 2), slice(1, None, 2)):
        side = records[half]
        perm = order.permutation(len(side))
        sides.append([side[i] for i in perm])
        side_ids.append(ids[half][perm])
    d = int(spec["d"])
    return Tables(emb=[trigram_embeddings(s, d) for s in sides], ids=side_ids,
                  columns=[{}, {}], records=sides)
