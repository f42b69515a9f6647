"""One run of a cell: set-up, the measured window, and the comparison.

A session builds the kernels (cached in the checkout), makes the tables and
the Oracle from the seed, registers the tables with the system's
``JoinMLEngine``, and warms the cell's shapes with one query of the mix's
first template.  The window is the mix's ``clients`` (default 1), each a
closed loop: a client's k-th query runs template k mod the rotation with
its own seed, and its next starts when it has returned.  With a mix's
``service`` (``workers``, ``max_wait_ms``, ``label_store_mb``), every
query's Oracle is attached to one ``OracleService`` (with an in-memory
``LabelStore`` when ``label_store_mb`` is given) for the query's length.
A query counts as failed when it raises or spends more than its budget.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
import traceback
from typing import Optional

import torch

from harness.capture import StrataCapture
from harness.common import parse_sql, sub_seed
from harness.spec import Cell, load_module, merge
from reference import sweep as ref_sweep


@dataclasses.dataclass
class QueryRecord:
    index: int
    sql: str
    latency_s: float
    ok: bool
    estimate: float = float("nan")
    lo: float = float("nan")
    hi: float = float("nan")
    calls: int = 0
    timings: dict = dataclasses.field(default_factory=dict)
    error: str = ""


@dataclasses.dataclass
class Window:
    records: list
    window_s: float
    trace: Optional[object] = None      # trace.Summary of a traced window

    @property
    def completed(self) -> list:
        return [r for r in self.records if r.ok]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    def __init__(self, cell: Cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.mix = cell.config, cell.mix
        self.templates = list(self.mix["templates"])
        self.clients = int(self.mix.get("clients", 1))
        self.service = None
        self._local = threading.local()

    def setup(self) -> None:
        from repro_torch.core import BASConfig, Catalog, JoinMLEngine, Table

        if torch.device(self.device).type == "cuda":
            from repro_torch.kernels import cuda_lib

            cuda_lib.build()
        conf = self.config
        self.tables = load_module("tables", conf["tables"]["kind"]).make(
            conf["tables"], self.seed, self.device)
        self.oracle = load_module("oracles", conf["oracle"]["kind"]).Side(self)
        catalog = Catalog()
        for name, emb, cols in zip(("a", "b"), self.tables.emb, self.tables.columns):
            catalog.register(Table(name, emb, dict(cols)))
        bas = merge(self.mix.get("bas", {}), conf.get("bas", {}))
        factory = self.oracle.factory
        if self.mix.get("service"):
            self.service = self._service(self.mix["service"])

            def factory(nl, names, base=self.oracle.factory):
                self._local.oracle = base(nl, names)
                self.service.attach(self._local.oracle)
                return self._local.oracle

        self.engine = JoinMLEngine(catalog, factory, cfg=BASConfig(**bas), device=self.device)
        self.capture = StrataCapture()
        self.capture.install()
        self.run_query(0, 0, sub_seed(self.seed, "warm-up"))
        sync(self.device)
        self.capture.reset()

    @staticmethod
    def _service(conf: dict):
        from repro_torch.serve import LabelStore, OracleService

        store = (LabelStore(max_bytes=int(conf["label_store_mb"]) << 20)
                 if conf.get("label_store_mb") else None)
        return OracleService(workers=int(conf.get("workers", 1)),
                             max_wait_ms=float(conf.get("max_wait_ms", 8.0)),
                             label_store=store)

    def close(self) -> None:
        self.capture.uninstall()
        if self.service is not None:
            self.service.close()

    def run_query(self, i: int, k: int, qseed: int) -> QueryRecord:
        """Query ``i`` of the window: template ``k`` mod the rotation."""
        sql = self.templates[k % len(self.templates)]
        budget = parse_sql(sql)[2]
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"portbench.query.{i}"):
                res = self.engine.execute(sql, method=self.mix["method"], seed=qseed)
            sync(self.device)
        except Exception:   # a failed query is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            return QueryRecord(i, sql, time.perf_counter() - t0, False,
                               error=traceback.format_exc(limit=1))
        finally:
            if self.service is not None and getattr(self._local, "oracle", None) is not None:
                self.service.detach(self._local.oracle)
                self._local.oracle = None
        lat = time.perf_counter() - t0
        ok = res.oracle_calls <= budget
        if not ok:
            print(f"query {i}: {res.oracle_calls} Oracle calls over its budget {budget}",
                  file=sys.stderr)
        return QueryRecord(i, sql, lat, ok, float(res.estimate), float(res.ci.lo),
                           float(res.ci.hi), int(res.oracle_calls),
                           dict(res.telemetry.timings))

    def window(self, seconds: Optional[float] = None, n_queries: Optional[int] = None,
               trace: bool = False) -> Window:
        """Each client's queries back to back until ``seconds`` have passed
        (a query started runs to its end) or it has run ``n_queries``."""
        from harness import trace as tr

        self.capture.reset()
        self.oracle.start_window()
        prof = tr.start() if trace else None
        records, lock, ids = [], threading.Lock(), itertools.count()
        t0 = time.perf_counter()

        def client(c: int) -> None:
            for k in itertools.count():
                if n_queries is not None and k >= n_queries:
                    return
                if seconds is not None and time.perf_counter() - t0 >= seconds:
                    return
                qseed = sub_seed(self.seed, "query", k) if c == 0 else \
                    sub_seed(self.seed, "query", c, k)
                with lock:
                    i = next(ids)
                rec = self.run_query(i, k, qseed)
                with lock:
                    records.append(rec)

        if self.clients == 1:
            client(0)
        else:
            threads = [threading.Thread(target=client, args=(c,)) for c in range(self.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        records.sort(key=lambda r: r.index)
        sync(self.device)
        window_s = time.perf_counter() - t0
        self.oracle.stop_window()
        summary = tr.stop(prof, records) if trace else None
        return Window(records, window_s, summary)

    # ---- the comparison --------------------------------------------------

    def reference_sweep(self, tf32: bool = False) -> ref_sweep.Sweep:
        n1, n2 = self.tables.sizes
        m, _ = ref_sweep.blocking_size(parse_sql(self.templates[0])[2], n1 * n2)
        return ref_sweep.sweep(self.tables.emb[0], self.tables.emb[1],
                               self.config["n_bins"], keep=m + 256, tf32=tf32,
                               device=self.device)

    def checks(self, win: Window) -> dict:
        """The numbers the configuration's ``limits`` name, of: the
        stratifications the window produced against the plain sweep (the
        worst of them), then the Oracle kind's own numbers.  A stratification
        without its histogram or walk sums reads as infinitely far."""
        done = win.completed
        out = {"strata_missing": float(len(done) - min(self.capture.count, len(done)))}
        ref = self.reference_sweep()
        worst = {}
        for st in self.capture.distinct:
            if st.counts is None or st.row_sums is None:
                worst = {k: float("inf") for k in ("hist_l1", "strata_gap", "rowsum_rel")}
                break
            for k, v in ref_sweep.judge(st, ref, *self.tables.emb).items():
                worst[k] = max(worst.get(k, 0.0), v)
        out.update(worst)
        out.update(self.oracle.checks(self, done))
        self._ref = ref
        return {k: out.get(k) for k in self.config["limits"]}

    def control(self, win: Window) -> dict:
        """The control's readings: the plain sweep with TF32 inputs in the
        system's place, and the Oracle kind's own lower-precision run."""
        n1, n2 = self.tables.sizes
        m, k = ref_sweep.blocking_size(parse_sql(self.templates[0])[2], n1 * n2)
        low = ref_sweep.as_strata(self.reference_sweep(tf32=True), m, k)
        out = ref_sweep.judge(low, self._ref, *self.tables.emb)
        out.update(self.oracle.control(self, win.completed))
        return {k: out[k] for k in self.config["limits"] if k in out}
