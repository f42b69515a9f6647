"""The exact answer of an aggregate over a join whose pairs match when their
entity ids are equal, from the ids and the value columns alone."""
from __future__ import annotations

import numpy as np


def aggregate(agg: str, expr: str, ids: list, columns: list) -> float:
    """COUNT(*), SUM(t.col) or AVG(t.col) over the matching pairs of tables
    ``a`` (left) and ``b`` (right)."""
    n_ent = int(max(ids[0].max(), ids[1].max())) + 1
    per = [np.bincount(i, minlength=n_ent).astype(np.float64) for i in ids]
    count = float(per[0] @ per[1])
    if agg == "COUNT":
        return count
    table, col = expr.strip().split(".")
    side = {"a": 0, "b": 1}[table]
    # every left row meets the right rows of its entity, and the other way
    total = float(np.asarray(columns[side][col], np.float64) @ per[1 - side][ids[side]])
    if agg == "SUM":
        return total
    if agg == "AVG":
        return total / count
    raise ValueError(f"no exact answer for {agg}")
