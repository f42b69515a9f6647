"""What the benchmark reads off the timed path, without changing it.

* :class:`StrataCapture` keeps the stratification each streaming query
  produced: the histogram, the blocking regime's order and stratum bounds,
  and the fused walk sums.  It wraps the streaming engine's stratifier
  (``repro_torch.core.bas_streaming.stratify_streaming_chain``), the one
  place where the system's stratification is handed from the sweep to the
  sampler; the wrapper returns what it was given.  Repeated queries on the
  same tables give the same stratification, so only distinct ones are kept.
* :class:`RecordingScorer` sits between the Oracle and the system's pair
  scorer: it times each ``score`` call (which ends in a copy to the host)
  and, while recording, keeps the pairs and the P(match) it returned.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from reference.sweep import Strata


class StrataCapture:
    def __init__(self):
        self.distinct: list = []
        self.count = 0
        self._orig = None
        self._lock = threading.Lock()   # concurrent clients' queries

    def install(self):
        from repro_torch.core import bas_streaming

        self._orig = bas_streaming.stratify_streaming_chain

        def stratify(*args, **kwargs):
            strat = self._orig(*args, **kwargs)
            self.add(strat)
            return strat

        bas_streaming.stratify_streaming_chain = stratify

    def uninstall(self):
        if self._orig is not None:
            from repro_torch.core import bas_streaming

            bas_streaming.stratify_streaming_chain = self._orig
            self._orig = None

    def reset(self):
        self.distinct, self.count = [], 0

    def add(self, strat):
        sw = strat.sweep
        got = Strata(
            counts=np.array(sw.counts, np.int64) if sw is not None else None,
            order=np.array(strat.order, np.int64),
            bounds=np.array(strat.bounds, np.int64),
            row_sums=(np.array(sw.row_sums[0], np.float64)
                      if sw is not None and sw.row_sums is not None else None),
            total=(float(sw.total_weight)
                   if sw is not None and sw.total_weight is not None else float("nan")),
        )
        with self._lock:
            self.count += 1
            for st in self.distinct:
                if (np.array_equal([st.total], [got.total], equal_nan=True)
                        and np.array_equal(st.order, got.order)
                        and np.array_equal(st.bounds, got.bounds)
                        and _same(st.counts, got.counts)
                        and _same(st.row_sums, got.row_sums)):
                    return
            self.distinct.append(got)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(a, b)


class RecordingScorer:
    def __init__(self, scorer):
        self.scorer = scorer
        self.seconds = 0.0
        self.recording = False
        self.calls: list = []     # [(pairs, probs)] while recording

    def score(self, pairs):
        t0 = time.perf_counter()
        out = self.scorer.score(pairs)
        self.seconds += time.perf_counter() - t0
        if self.recording:
            self.calls.append((np.array(pairs, np.int64), np.array(out, np.float64)))
        return out
