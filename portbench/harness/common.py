"""Seeds and the tables a configuration's generator hands to both sides."""
from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Optional

import numpy as np


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of a run (tables, weights, query i, ...),
    from the run's ``--seed``, which may be any whole number."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for k in keys:
        words.append(zlib.crc32(str(k).encode()) if isinstance(k, str) else int(k))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


@dataclasses.dataclass
class Tables:
    """Two tables: unit f32 embedding rows, each record's entity id, attribute
    columns, and (for text records) the records themselves."""
    emb: list                     # [(n1, d), (n2, d)] float32
    ids: list                     # [(n1,), (n2,)] int64
    columns: list                 # [{name: (n,) float64}, ...]
    records: Optional[list] = None  # [[str] * n1, [str] * n2]

    @property
    def sizes(self) -> tuple:
        return tuple(int(e.shape[0]) for e in self.emb)


_AGG = re.compile(r"SELECT\s+(COUNT|SUM|AVG)\s*\(\s*([^)]*?)\s*\)", re.I)
_BUDGET = re.compile(r"ORACLE\s+BUDGET\s+(\d+)", re.I)
_PROB = re.compile(r"WITH\s+PROBABILITY\s+([\d.]+)", re.I)


def parse_sql(sql: str) -> tuple:
    """(aggregate, expression, budget, confidence) of a query template."""
    m = _AGG.search(sql)
    if m is None:
        raise ValueError(f"no COUNT, SUM or AVG in {sql!r}")
    return (m.group(1).upper(), m.group(2), int(_BUDGET.search(sql).group(1)),
            float(_PROB.search(sql).group(1)))
