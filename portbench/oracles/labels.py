"""Oracle kind ``labels``: the ground truth is given, as in the paper's
evaluation, and every call is counted.  A pair matches when its records'
entity ids are equal; the system's ``FnOracle`` asks for the labels.

The exact answer follows from the ids, so each completed query's estimate
is judged against it in half-widths of its own confidence interval.
"""
from __future__ import annotations

import numpy as np

from harness.common import parse_sql
from reference.truth import aggregate


class Side:
    def __init__(self, session):
        from repro_torch.core import FnOracle

        ids1, ids2 = session.tables.ids

        def same_entity(idx: np.ndarray) -> np.ndarray:
            return (ids1[idx[:, 0]] == ids2[idx[:, 1]]).astype(np.float64)

        self.factory = lambda nl, names: FnOracle(same_entity)

    def start_window(self):
        pass

    def stop_window(self):
        pass

    def checks(self, session, records: list) -> dict:
        """``est_halfwidths``: the largest |estimate - truth| over the
        completed queries, in half-widths of the query's interval."""
        t = session.tables
        worst = 0.0
        truths = {}
        for r in records:
            agg, expr, _, _ = parse_sql(r.sql)
            if r.sql not in truths:
                truths[r.sql] = aggregate(agg, expr, t.ids, t.columns)
            half = (r.hi - r.lo) / 2.0
            err = abs(r.estimate - truths[r.sql])
            worst = max(worst, err / half if half > 0 else (0.0 if err == 0 else np.inf))
        return {"est_halfwidths": float(worst)} if records else {}

    def control(self, session, records: list) -> dict:
        return {}
