"""The port's OracleService (``repro_torch.serve.oracle_service``) and TCP
transport (``repro_torch.serve.transport``), held against the reference's
(``repro.serve``): cross-query coalescing, in process and over loopback
TCP.  Mirrors ``tests/test_oracle_service.py`` case for case, with the same
counters and labels.

The contract under test: routing any number of concurrent queries through
one service changes *where* labelling executes (shared micro-batched windows
on a worker pool, possibly behind a network transport, possibly sharded
across worker hosts) but nothing about *what* each query computes —
estimates are bit-identical to serial execution, ledgers stay per-query, and
one query's budget exhaustion, backend failure, or transport drop never
touches another query's batch.

Each case runs the same windows through both packages: the port's
observables (``stats()``, ledgers, labels, shard sizes, errors) must equal
the reference's.  Estimates of the two packages' BAS agree to ``rel=1e-6``
(``tests/test_torch_bas.py``); within a package they are bit-identical.

No timer decides a result here.  A window that must gather several clients
runs with ``max_wait_ms=WAIT`` (60 s) and closes because every client is
present; had it waited for its timer, the bounded ``result(timeout=...)``
would fail first.  Slowness is injected (EWMA and class rates set directly,
backends held on an event), worker health is checked by one explicit sweep,
every blocking call has a bound, servers bind port 0, and the autouse
fixture fails a test whose service, server or connection threads outlive
it.
"""
import contextlib
import random
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R_core
import repro.core.oracle as R_oracle
import repro.data as R_data
import repro.obs as R_obs
import repro.serve.oracle_service as R_svc
import repro.serve.transport as R_wire
import repro_torch.core as P_core
import repro_torch.core.oracle as P_oracle
import repro_torch.data as P_data
import repro_torch.obs as P_obs
import repro_torch.serve.oracle_service as P_svc
import repro_torch.serve.transport as P_wire

WAIT = 60_000.0     # ms: windows close by presence, never by this timer
BOUND = 30.0        # s: every blocking wait in these tests
REL = 1e-6          # the port's BAS against the reference's


def _serve_bounded(svc, jobs):
    """The reference's ``serve_queries`` (which takes no timeout), bounded."""
    out, err = {}, []

    def run():
        try:
            out["results"] = R_svc.serve_queries(svc, jobs)
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120.0)
    assert not t.is_alive(), "the queries never finished"
    if err:
        raise err[0]
    return out["results"]


def _sweep(svc):
    """One health sweep in the reference, which runs it only inside its
    background loop (``OracleService._health_loop``): the loop's body."""
    with svc._cv:
        live = list(svc._remote_workers)
        dead = list(svc._dead_workers)
    for worker in dead:
        svc._revive_worker(worker)
    for worker in live:
        if not svc._worker_alive(worker):
            svc._mark_worker_dead(worker)


P = SimpleNamespace(
    core=P_core, oracle=P_oracle, data=P_data, obs=P_obs, svc=P_svc,
    wire=P_wire, run_kw={"device": "cpu"},
    serve=lambda svc, jobs: P_svc.serve_queries(svc, jobs, timeout=120.0),
    check=lambda svc: svc.check_workers())
R = SimpleNamespace(
    core=R_core, oracle=R_oracle, data=R_data, obs=R_obs, svc=R_svc,
    wire=R_wire, run_kw={}, serve=_serve_bounded, check=_sweep)


@pytest.fixture(autouse=True)
def no_leftover_threads():
    """Every service, server, exporter and connection a test opens is closed
    by its end: no thread it started may survive it."""
    before = set(threading.enumerate())
    yield
    new = [t for t in threading.enumerate() if t not in before]
    for t in new:
        t.join(timeout=BOUND)
    alive = [t.name for t in new if t.is_alive()]
    assert not alive, f"threads outlived the test: {alive}"


def _both(scenario, *args):
    """The scenario's observables in the port and in the reference."""
    return scenario(P, *args), scenario(R, *args)


def _mk_query(pk, seed, budget=1500, n=100):
    ds = pk.data.make_clustered_tables(n, n, n_entities=150, noise=0.4,
                                       seed=seed)
    return pk.core.Query(spec=ds.spec(), agg=pk.core.Agg.COUNT,
                         oracle=ds.oracle(), budget=budget)


def _est(res):
    return (res.estimate, res.ci.lo, res.ci.hi)


def _ledger(o):
    return (o.calls, o.requests, o.batches)


def _label(pk, oracle, idx):
    """``oracle.label(idx)`` with a bounded wait on the flush."""
    batch = pk.core.OracleBatch(oracle)
    handle = batch.submit(idx)
    batch.flush_async().result(timeout=BOUND)
    return handle.labels


def _remote(pk, address, group, **kw):
    """A query client whose round trips are bounded and not retried (a
    transport failure then fails the test at once)."""
    kw = {"timeout_s": BOUND, "retries": 0, **kw}
    return pk.wire.RemoteOracle(address, group, **kw)


def _hang_up(conn):
    """Close a client connection so that the server sees it go.  The
    reference's ``close()`` alone leaves its reader blocked in ``recv`` and
    sends no FIN, so its server would go on counting the client toward
    window assembly; a shutdown first hangs up in both packages."""
    if conn._sock is not None:
        try:
            conn._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    conn.close()


@contextlib.contextmanager
def _client(pk, address, group, **kw):
    """``_remote`` for a ``with`` block that hangs up at its end, so that a
    later client of the same server does not wait for this one."""
    o = _remote(pk, address, group, **kw)
    try:
        yield o
    finally:
        _hang_up(o.conn)


def _dead_address():
    """A loopback address nothing listens on: an ephemeral port, released."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()


def _until(service, pred):
    """Wait, bounded, until ``pred()`` holds under the service's lock.  It
    re-checks every 10 ms: the reference's dispatcher does not notify the
    condition when a window ends or a client registers."""
    end = time.monotonic() + BOUND
    with service._cv:
        while not pred():
            assert time.monotonic() < end, "condition not met"
            service._cv.wait(0.01)


def _join(threads):
    for t in threads:
        t.join(timeout=BOUND)
    assert not any(t.is_alive() for t in threads), "a flush never finished"


def _outcome(e):
    return None if e is None else type(e).__name__


# ----------------------------------------------------------------------------
# bit-identical estimates + untouched ledgers
# ----------------------------------------------------------------------------

def _concurrent_queries(pk):
    seeds = (1, 2, 3, 4)
    serial, serial_ledgers = [], []
    for s in seeds:
        q = _mk_query(pk, s)
        serial.append(_est(pk.core.run_bas(q, seed=s, **pk.run_kw)))
        serial_ledgers.append((q.oracle.calls, q.oracle.requests))

    with pk.svc.OracleService(workers=2, max_wait_ms=WAIT) as svc:
        queries = [_mk_query(pk, s) for s in seeds]
        svc.attach(*[q.oracle for q in queries])

        def job(q, s):
            try:
                return pk.core.run_bas(q, seed=s, **pk.run_kw)
            finally:
                svc.detach(q.oracle)

        results = pk.serve(
            svc, [lambda q=q, s=s: job(q, s) for q, s in zip(queries, seeds)])
        stats = svc.stats()
    return {"serial": serial, "served": [_est(r) for r in results],
            "exact": {"serial": serial_ledgers,
                      "served": [(q.oracle.calls, q.oracle.requests)
                                 for q in queries],
                      "stats": stats}}


def test_concurrent_queries_bit_identical_to_serial():
    """Two (and more) queries sharing one OracleService must produce exactly
    the estimates, CIs, and ledger counts of running them serially."""
    port, ref = _both(_concurrent_queries)
    assert port["served"] == port["serial"]          # bit-identical
    ex = port["exact"]
    assert ex["served"] == ex["serial"]              # same ledger charge
    # and the flushes actually coalesced across queries
    assert ex["stats"]["segments"] >= 4 * 4
    assert ex["stats"]["windows"] < ex["stats"]["segments"]
    assert ex == ref["exact"]
    assert np.ravel(port["served"]) == pytest.approx(np.ravel(ref["served"]),
                                                     rel=REL, abs=1e-9)


def _budget_exhausted(pk):
    ok_ref = _mk_query(pk, 7)
    ref = pk.core.run_bas(ok_ref, seed=7, **pk.run_kw)

    with pk.svc.OracleService(max_wait_ms=WAIT) as svc:
        # budget 6 < the pilot-stage minimum draw -> BudgetExceeded mid-pipeline
        poor = _mk_query(pk, 5, budget=6)
        ok = _mk_query(pk, 7)
        svc.attach(poor.oracle, ok.oracle)
        errs = []

        def run_poor():
            try:
                pk.core.run_bas(poor, seed=5, **pk.run_kw)
            except pk.oracle.BudgetExceeded as e:
                errs.append(e)
            finally:
                svc.detach(poor.oracle)

        def run_ok():
            try:
                return pk.core.run_bas(ok, seed=7, **pk.run_kw)
            finally:
                svc.detach(ok.oracle)

        t = threading.Thread(target=run_poor)
        t.start()
        res = run_ok()
        _join([t])
        stats = svc.stats()
    return {"solo": _est(ref), "served": _est(res),
            "exact": {"errors": len(errs), "poor": _ledger(poor.oracle),
                      "ok": _ledger(ok.oracle), "solo": _ledger(ok_ref.oracle),
                      "stats": stats}}


def test_budget_exhausted_query_leaves_others_untouched():
    """A query that blows its budget mid-pipeline fails alone; a concurrent
    query in the same service windows is bit-identical to running solo."""
    port, ref = _both(_budget_exhausted)
    ex = port["exact"]
    assert ex["errors"] == 1                         # poor query failed...
    assert ex["poor"][0] == 0                        # ...charging nothing
    assert port["served"] == port["solo"]            # other query untouched
    assert ex["ok"][0] == ex["solo"][0]
    assert ex == ref["exact"]
    assert port["served"] == pytest.approx(ref["served"], rel=REL, abs=1e-9)


# ----------------------------------------------------------------------------
# window-level failure isolation + retry
# ----------------------------------------------------------------------------

def _flush_concurrently(batches):
    """Flush all batches from separate threads so they land in one service
    window; returns the futures' exceptions (None for success)."""
    outcomes = [None] * len(batches)
    barrier = threading.Barrier(len(batches))

    def go(i):
        barrier.wait(timeout=BOUND)
        try:
            batches[i].flush_async().result(timeout=BOUND)
        except BaseException as e:  # noqa: BLE001
            outcomes[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    _join(threads)
    return outcomes


def _parity_fn(idx):
    return (idx.sum(axis=1) % 2).astype(np.float64)


def _parity_oracle(pk, n=64):
    o = pk.core.FnOracle(_parity_fn)
    o.bind_sizes((n, n))
    return o


def _budget_failure(pk):
    a, b = _parity_oracle(pk), _parity_oracle(pk)
    a.set_budget(2)
    idx_a = np.array([[0, 1], [2, 3], [4, 5]])      # 3 new > budget 2
    idx_b = np.array([[1, 2], [3, 4]])
    with pk.svc.OracleService(max_wait_ms=WAIT) as svc:
        svc.attach(a, b)
        ba, bb = pk.core.OracleBatch(a), pk.core.OracleBatch(b)
        ha, hb = ba.submit(idx_a), bb.submit(idx_b)
        out = _flush_concurrently([ba, bb])
        failed = (_ledger(a), _ledger(b), hb.labels.tolist(), svc.stats())
        # a is untouched and retryable: raise the budget, same batch succeeds
        # (b is done: detached, the retry's window has nobody to wait for)
        svc.detach(b)
        a.set_budget(5)
        ba.flush_async().result(timeout=BOUND)
        stats = svc.stats()
    return {"out": [_outcome(e) for e in out], "failed": failed,
            "retried": (_ledger(a), ha.labels.tolist()), "stats": stats}


def test_budget_failure_isolated_and_retryable_in_one_window():
    port, ref = _both(_budget_failure)
    assert port["out"] == ["BudgetExceeded", None]
    a, b, b_labels, stats = port["failed"]
    assert stats["windows"] == 1                     # one window, by presence
    # b's window-mate failure never reached b
    assert b_labels == [1.0, 1.0]
    assert b[:2] == (2, 2)
    assert a == (0, 0, 0)                            # a untouched
    a, a_labels = port["retried"]
    assert a[0] == 3 and a_labels == [1.0, 1.0, 1.0]
    assert port == ref


def _backend_error(pk):
    state = {"fail": True}

    def flaky(idx):
        if state["fail"]:
            raise RuntimeError("transient backend error")
        return _parity_fn(idx)

    a = pk.core.FnOracle(flaky)
    a.bind_sizes((64, 64))
    b = _parity_oracle(pk)
    idx = np.array([[1, 2], [3, 4], [5, 6]])
    with pk.svc.OracleService(max_wait_ms=WAIT) as svc:
        svc.attach(a, b)
        ba, bb = pk.core.OracleBatch(a), pk.core.OracleBatch(b)
        ha, hb = ba.submit(idx), bb.submit(idx)
        out = _flush_concurrently([ba, bb])
        failed = (_ledger(a), _ledger(b), hb.labels.tolist(), svc.stats())
        svc.detach(b)
        state["fail"] = False
        ba.flush_async().result(timeout=BOUND)       # retryable
        stats = svc.stats()
    return {"out": [_outcome(e) for e in out],
            "message": str(out[0]), "failed": failed,
            "retried": (_ledger(a), ha.labels.tolist()), "stats": stats}


def test_backend_error_isolated_and_retryable_in_one_window():
    port, ref = _both(_backend_error)
    assert port["out"] == ["RuntimeError", None]
    assert "transient backend error" in port["message"]
    a, _, b_labels, stats = port["failed"]
    assert stats["windows"] == 1
    assert b_labels == [1.0, 1.0, 1.0]
    assert a[0] == 0 and a[2] == 0                   # atomic failure
    a, a_labels = port["retried"]
    assert a[0] == 3 and a_labels == [1.0, 1.0, 1.0]
    assert port == ref


# ----------------------------------------------------------------------------
# cross-query super-batch fusion + worker sharding
# ----------------------------------------------------------------------------

def _fused(pk):
    calls = []

    def scorer(idx):
        calls.append(np.array(idx))
        return _parity_fn(idx)

    a = pk.core.ModelOracle(scorer, threshold=0.5)
    b = pk.core.ModelOracle(scorer, threshold=0.5)
    for o in (a, b):
        o.bind_sizes((64, 64))

    # a scorer *object* with a .score method (the PairScorer shape) must fuse
    # too: ModelOracle stores the bound method, whose id is per-access
    class _Scorer:
        def score(self, idx):
            return np.zeros(len(idx))

    shared = _Scorer()
    groups = (a.service_group() == b.service_group(),
              pk.core.ModelOracle(shared).service_group()
              == pk.core.ModelOracle(shared).service_group(),
              pk.core.ModelOracle(shared).service_group()
              != pk.core.ModelOracle(_Scorer()).service_group())
    idx_a = np.array([[0, 1], [2, 3]])
    idx_b = np.array([[2, 3], [4, 5]])              # overlaps a; NOT deduped
    with pk.svc.OracleService(max_wait_ms=WAIT) as svc:
        svc.attach(a, b)
        ba, bb = pk.core.OracleBatch(a), pk.core.OracleBatch(b)
        ha, hb = ba.submit(idx_a), bb.submit(idx_b)
        out = _flush_concurrently([ba, bb])
        stats = svc.stats()
    return {"groups": groups, "out": out,
            "backend": [len(c) for c in calls],
            "ledgers": (_ledger(a), _ledger(b)),
            "labels": (ha.labels.tolist(), hb.labels.tolist()),
            "stats": stats}


def test_shared_scorer_queries_fuse_into_one_backend_call():
    """ModelOracles scoring through one shared scorer share a service group:
    concurrent flushes fuse into a single backend execution."""
    port, ref = _both(_fused)
    assert port["groups"] == (True, True, True)
    assert port["out"] == [None, None]
    assert port["backend"] == [4]                    # one fused super-batch
    a, b = port["ledgers"]                           # ledgers stay per-query:
    assert a[0] == 2 and b[0] == 2                   # no cross-oracle dedup
    assert port["labels"] == ([1.0, 1.0], [1.0, 1.0])
    assert port == ref


def _pool_shards(pk):
    sizes = []
    lock = threading.Lock()

    def fn(idx):
        with lock:
            sizes.append(len(idx))
        return _parity_fn(idx)

    o = pk.core.FnOracle(fn)
    o.bind_sizes((1000, 1000))
    rng = np.random.default_rng(0)
    idx = np.unique(rng.integers(0, 1000, size=(4096, 2)), axis=0)
    with pk.svc.OracleService(workers=4, min_shard=256,
                              max_wait_ms=WAIT) as svc:
        svc.attach(o)
        got = _label(pk, o, idx)
        stats = svc.stats()
    return {"rows": len(idx), "sizes": sorted(sizes),
            "right": bool((got == idx.sum(1) % 2).all()), "stats": stats}


def test_worker_pool_shards_large_flushes():
    port, ref = _both(_pool_shards)
    assert len(port["sizes"]) == 4                   # sharded over the pool
    assert sum(port["sizes"]) == port["rows"]
    assert port["right"]
    assert port == ref


def _solo(pk):
    o = _parity_oracle(pk)
    with pk.svc.OracleService(max_wait_ms=WAIT) as svc:
        svc.attach(o)
        got = _label(pk, o, np.array([[1, 2], [3, 4]]))
        return got.tolist(), svc.stats()


def test_solo_client_dispatches_without_deadline_wait():
    """With every attached client already in the window there is nobody to
    wait for: a solo query's flush resolves long before the 60 s window
    timer could close its window."""
    port, ref = _both(_solo)
    assert port[0] == [1.0, 1.0]
    assert port[1]["windows"] == 1
    assert port == ref


def _detached(pk):
    o = _parity_oracle(pk)
    svc = pk.svc.OracleService(max_wait_ms=WAIT)
    svc.attach(o)
    attached = o.service is svc
    svc.detach(o)
    detached = o.service is None
    got = o.label(np.array([[1, 2]]))
    svc.close()
    return attached, detached, got.tolist(), svc.stats()


def test_detached_oracle_flushes_locally_again():
    port, ref = _both(_detached)
    assert port[:3] == (True, True, [1.0])
    assert port[3]["windows"] == 0                   # never reached the service
    assert port == ref


def _after_close(pk):
    o = _parity_oracle(pk)
    svc = pk.svc.OracleService(max_wait_ms=WAIT)
    svc.attach(o)
    svc.close()
    batch = pk.core.OracleBatch(o)
    batch.submit(np.array([[1, 2]]))
    with pytest.raises(RuntimeError) as ei:
        batch.flush_async()
    pending = len(batch._pending)                    # retryable after detach
    o.service = None
    batch.flush()
    return str(ei.value), pending, _ledger(o)


def test_submit_after_close_raises_and_restores_pending():
    port, ref = _both(_after_close)
    assert port[1] == 1
    assert port[2][0] == 1
    assert port == ref


# ----------------------------------------------------------------------------
# multi-host dispatch: the TCP transport (repro_torch.serve.transport)
# ----------------------------------------------------------------------------

def _payloads(pk):
    req = pk.oracle.LabelRequest("pairs", np.array([[1, 2], [3, 4], [5, 6]]),
                                 request_id=42)
    got = pk.oracle.LabelRequest.from_bytes(req.to_bytes())
    empty = pk.oracle.LabelRequest.from_bytes(
        pk.oracle.LabelRequest("g", np.empty((0, 3), np.int64)).to_bytes())
    res = pk.oracle.LabelResult(request_id=42,
                                labels=np.array([1.0, 0.0, 1.0]))
    back = pk.oracle.LabelResult.from_bytes(res.to_bytes())
    err = pk.oracle.LabelResult(request_id=7, error="RuntimeError: boom")
    err_back = pk.oracle.LabelResult.from_bytes(err.to_bytes())
    return {"bytes": (req.to_bytes(), res.to_bytes(), err.to_bytes()),
            "request": (got.group, got.request_id, str(got.idx.dtype),
                        got.idx.tolist()),
            "empty": empty.idx.shape,
            "result": (back.ok, back.request_id, back.labels.tolist()),
            "error": (err_back.ok, err_back.error)}


def test_wire_payload_roundtrip():
    """LabelRequest/LabelResult survive encode->decode exactly, including
    empty segments and error results (the transport's unit contract), and
    encode to the reference's bytes."""
    port, ref = _both(_payloads)
    assert port["request"] == ("pairs", 42, "int64", [[1, 2], [3, 4], [5, 6]])
    assert port["empty"] == (0, 3)
    assert port["result"] == (True, 42, [1.0, 0.0, 1.0])
    assert port["error"] == (False, "RuntimeError: boom")
    assert port == ref


def _remote_bas(pk):
    ds = pk.data.make_clustered_tables(80, 80, n_entities=120, noise=0.4,
                                       seed=11)
    local = ds.oracle()
    q_local = pk.core.Query(spec=ds.spec(), agg=pk.core.Agg.COUNT,
                            oracle=local, budget=1200)
    ref = pk.core.run_bas(q_local, seed=11, **pk.run_kw)

    with pk.wire.OracleServiceServer({"truth": local._label},
                                     max_wait_ms=WAIT) as server:
        with _client(pk, server.address, "truth") as remote:
            q_remote = pk.core.Query(spec=ds.spec(), agg=pk.core.Agg.COUNT,
                                     oracle=remote, budget=1200)
            got = pk.core.run_bas(q_remote, seed=11, **pk.run_kw)
        stats = server.service.stats()
    return {"local": _est(ref), "remote": _est(got),
            "exact": {"local": _ledger(local), "remote": _ledger(remote),
                      "stats": stats}}


def test_remote_execution_bit_identical_to_in_process():
    """A BAS query labelling through a loopback TCP server must produce
    exactly the estimate, CI, and ledger counts of the same query labelling
    in-process — the transport changes where labels execute, nothing else."""
    port, ref = _both(_remote_bas)
    assert port["remote"] == port["local"]
    ex = port["exact"]
    assert ex["remote"][:2] == ex["local"][:2]
    assert ex["stats"]["rows_labelled"] == ex["local"][0]  # server did it all
    assert ex == ref["exact"]
    assert port["remote"] == pytest.approx(ref["remote"], rel=REL, abs=1e-9)


def _coalesce_remote(pk):
    with pk.wire.OracleServiceServer({"parity": _parity_fn},
                                     max_wait_ms=WAIT) as server:
        svc = server.service
        a = _remote(pk, server.address, "parity")
        b = _remote(pk, server.address, "parity")
        # both HELLOs registered: the first EXEC's window waits for the other
        _until(svc, lambda: len(svc._remote_clients) == 2)
        for o in (a, b):
            o.bind_sizes((64, 64))
        ba, bb = pk.core.OracleBatch(a), pk.core.OracleBatch(b)
        ha = ba.submit(np.array([[0, 1], [2, 3]]))
        hb = bb.submit(np.array([[4, 5], [6, 7], [8, 9]]))
        out = _flush_concurrently([ba, bb])
        stats = svc.stats()
        a.close()
        b.close()
    return {"out": out, "labels": (ha.labels.tolist(), hb.labels.tolist()),
            "stats": stats}


def test_remote_flushes_coalesce_across_connections():
    """EXEC segments arriving on different client connections land in shared
    service windows, exactly like attached in-process oracles."""
    port, ref = _both(_coalesce_remote)
    assert port["out"] == [None, None]
    assert port["labels"] == ([1.0, 1.0], [1.0, 1.0, 1.0])
    assert port["stats"]["windows"] == 1 and port["stats"]["segments"] == 2
    assert port == ref


def _restart_mid_query(pk):
    server = pk.wire.OracleServiceServer({"parity": _parity_fn},
                                         max_wait_ms=WAIT)
    host, port = server.address
    o = pk.wire.RemoteOracle((host, port), "parity", backoff_s=0.01,
                             timeout_s=BOUND)
    try:
        o.bind_sizes((64, 64))
        o.set_budget(5)
        batch = pk.core.OracleBatch(o)
        h1 = batch.submit(np.array([[1, 2], [3, 4]]))
        batch.flush_async().result(timeout=BOUND)
        first = (h1.labels.tolist(), o.calls, o.requests)

        server.close()                               # the fleet host dies...
        server = pk.wire.OracleServiceServer(
            {"parity": _parity_fn}, host=host, port=port,
            max_wait_ms=WAIT)                        # ...and returns
        # one duplicate of flush 1 (served from the local cache, never sent)
        # and two new tuples (sent after reconnect)
        h2 = batch.submit(np.array([[3, 4], [5, 6], [7, 8]]))
        batch.flush_async().result(timeout=BOUND)
        return {"first": first,
                "second": (h2.labels.tolist(), o.calls, o.requests,
                           o.remaining),
                "reconnected": o.conn.reconnects >= 1,
                "stats": server.service.stats()}
    finally:
        o.close()
        server.close()


def test_server_restart_mid_query_reconnects_without_double_charge():
    """The acceptance scenario: the server dies and is replaced between two
    flushes of one query.  The client's next flush rides the dead connection,
    observes the drop, reconnects, retries — and because the ledger is
    charged client-side only after a successful round trip, the charge is
    exact (no double charge, dedup intact across the restart)."""
    port, ref = _both(_restart_mid_query)
    assert port["first"] == ([1.0, 1.0], 2, 2)
    assert port["reconnected"]                       # the drop was observed
    # exact charge, no double
    assert port["second"] == ([1.0, 1.0, 1.0], 4, 5, 1)
    assert port == ref


def _dead_server(pk):
    o = pk.wire.RemoteOracle(_dead_address(), "parity", retries=1,
                             backoff_s=0.01, timeout_s=BOUND)
    o.bind_sizes((64, 64))
    batch = pk.core.OracleBatch(o)
    h = batch.submit(np.array([[1, 2], [3, 4]]))
    with pytest.raises(ConnectionError) as ei:
        batch.flush()
    failed = (type(ei.value).__name__, len(batch._pending), _ledger(o))

    with pk.wire.OracleServiceServer({"parity": _parity_fn},
                                     max_wait_ms=WAIT) as server:
        o.conn.address = server.address              # point at the live server
        batch.flush_async().result(timeout=BOUND)    # same batch, now succeeds
        o.close()
        stats = server.service.stats()
    return failed, (h.labels.tolist(), _ledger(o)), stats


def test_remote_transport_failure_is_atomic_and_retryable():
    """With no server listening at all, the flush fails with a transport
    error, the batch keeps its pending set, and the oracle is untouched —
    bringing the server up makes the SAME batch succeed."""
    port, ref = _both(_dead_server)
    _, pending, ledger = port[0]
    assert pending == 1                              # atomic failure
    assert ledger[:2] == (0, 0)
    labels, ledger = port[1]
    assert labels == [1.0, 1.0] and ledger[0] == 2
    assert port == ref


def _garbage(pk):
    with pk.wire.OracleServiceServer({"parity": _parity_fn},
                                     max_wait_ms=WAIT) as server:
        with socket.create_connection(server.address, timeout=BOUND) as sock:
            pk.wire.send_frame(sock, pk.wire.MSG_EXEC, b"\x01\x02garbage")
            mtype, payload = pk.wire.recv_frame(sock)
    return mtype, pk.oracle.LabelResult.from_bytes(payload).error


def test_undecodable_exec_payload_gets_error_reply_not_a_drop():
    """A corrupt EXEC payload is a deterministic protocol error: the server
    must answer with an ERROR frame (-> RemoteExecutionError on attempt 1),
    not drop the connection and send the client into a reconnect loop."""
    port, ref = _both(_garbage)
    assert port[0] == P.wire.MSG_ERROR
    assert "ProtocolError" in port[1]
    assert port == ref


def _control_plane(pk):
    with pk.wire.OracleServiceServer({"parity": _parity_fn},
                                     max_wait_ms=WAIT) as server:
        mon = pk.wire.ServiceConnection(server.address, timeout_s=BOUND)
        control = (mon.ping(), mon.groups())
        silent = socket.create_connection(server.address, timeout=BOUND)
        with _client(pk, server.address, "parity") as o:
            o.bind_sizes((64, 64))
            got = _label(pk, o, np.array([[1, 2], [3, 4]]))
        mon.close()
        silent.close()
        stats = server.service.stats()
    return control, got.tolist(), stats


def test_control_plane_connections_do_not_stall_windows():
    """Connections that never announce query work — PING/GROUPS control
    traffic, or a socket that sends no frame at all — must not count toward
    window assembly: a solo query next to them resolves long before the
    60 s window timer."""
    port, ref = _both(_control_plane)
    assert port[0] == (True, ("parity",))
    assert port[1] == [1.0, 1.0]
    assert port[2]["windows"] == 1
    assert port == ref


def _pipelined(pk):
    calls = []
    lock = threading.Lock()

    def fn(idx):
        with lock:
            calls.append(np.array(idx))
        return _parity_fn(idx)

    idxs = [np.array([[0, 1], [2, 3]]), np.array([[4, 5], [6, 7]])]
    results = [None, None]
    with pk.wire.OracleServiceServer({"parity": fn},
                                     max_wait_ms=WAIT) as server:
        svc = server.service
        holder = pk.wire.ServiceConnection(server.address, announce=True,
                                           timeout_s=BOUND)
        holder.connect()
        with pk.wire.ServiceConnection(server.address, announce=True,
                                       timeout_s=BOUND, retries=0) as conn:
            conn.connect()
            _until(svc, lambda: len(svc._remote_clients) == 2)
            barrier = threading.Barrier(2)

            def go(i):
                barrier.wait(timeout=BOUND)
                results[i] = conn.execute("parity", idxs[i]).tolist()

            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            _until(svc, lambda: svc._queued_rows == 4)   # both queued
            _hang_up(holder)          # nobody left to wait for: dispatch
            _join(threads)
        stats = svc.stats()
    return [len(c) for c in calls], results, stats


def test_pipelined_execs_on_one_connection_fuse_into_one_window():
    """Request pipelining: two concurrent EXECs on ONE connection must both
    be in flight server-side — i.e. fuse into a single window and a single
    backend call.  An announced client that never flushes holds the window
    open until both EXECs are queued; hanging it up releases the window."""
    port, ref = _both(_pipelined)
    assert port[0] == [4]                            # one fused backend call
    assert port[1] == [[1.0, 1.0], [1.0, 1.0]]       # demuxed to the right
    assert port[2]["windows"] == 1
    assert port == ref


def _backoffs(pk):
    c = pk.wire.ServiceConnection(_dead_address(), backoff_s=0.05,
                                  max_backoff_s=0.2)
    state = random.getstate()
    try:
        random.seed(20)               # the jitter's draws, alike in both
        sleeps = [c._backoff(a) for a in range(10)] * 3
        jitter = [c._backoff(5) for _ in range(20)]
    finally:
        random.setstate(state)
    return sleeps, jitter


def test_reconnect_backoff_is_capped_and_jittered():
    port, ref = _both(_backoffs)
    sleeps, jitter = port
    assert all(0 < s <= 0.2 * 1.5 for s in sleeps)   # cap * max jitter
    assert len({round(s, 9) for s in jitter}) > 1    # jittered
    assert port == ref


def _unknown_group(pk):
    with pk.wire.OracleServiceServer({"parity": _parity_fn},
                                     max_wait_ms=WAIT) as server:
        o = _remote(pk, server.address, "no-such-group")
        o.bind_sizes((64, 64))
        batch = pk.core.OracleBatch(o)
        batch.submit(np.array([[1, 2]]))
        with pytest.raises(pk.wire.RemoteExecutionError) as ei:
            batch.flush()
        out = (str(ei.value), len(batch._pending), _ledger(o))
        o.close()
    return out


def test_remote_unknown_group_raises_application_error():
    port, ref = _both(_unknown_group)
    assert "unknown group" in port[0]
    assert port[1] == 1 and port[2][0] == 0
    assert port == ref


def _remote_backend_error(pk):
    state = {"fail": True}

    def flaky(idx):
        if state["fail"]:
            raise RuntimeError("transient backend error")
        return _parity_fn(idx)

    with pk.wire.OracleServiceServer({"flaky": flaky},
                                     max_wait_ms=WAIT) as server:
        o = _remote(pk, server.address, "flaky")
        o.bind_sizes((64, 64))
        batch = pk.core.OracleBatch(o)
        h = batch.submit(np.array([[1, 2], [3, 4]]))
        with pytest.raises(pk.wire.RemoteExecutionError) as ei:
            batch.flush()
        failed = (str(ei.value), _ledger(o))
        state["fail"] = False
        batch.flush_async().result(timeout=BOUND)    # retryable
        o.close()
        stats = server.service.stats()
    return failed, (h.labels.tolist(), _ledger(o)), stats


def test_remote_backend_error_reaches_client_and_is_retryable():
    port, ref = _both(_remote_backend_error)
    message, ledger = port[0]
    assert "transient" in message
    assert ledger[0] == 0                            # atomic failure
    labels, ledger = port[1]
    assert labels == [1.0, 1.0] and ledger[0] == 2
    assert port == ref


def _fleet(pk, worker_fn, local_fn):
    """A worker host and a front server with two shards a super-batch (one
    local, one on the worker host) and no background health checker."""
    worker = pk.wire.OracleServiceServer({"parity": worker_fn},
                                         max_wait_ms=WAIT, health_check_s=0)
    front = pk.wire.OracleServiceServer({"parity": local_fn},
                                        max_wait_ms=WAIT, workers=1,
                                        min_shard=64, health_check_s=0)
    return worker, front


def _recording(sink, lock):
    def fn(idx):
        with lock:
            sink.append(len(idx))
        return _parity_fn(idx)
    return fn


def _sharded(pk):
    worker_rows, local_rows = [], []
    lock = threading.Lock()
    rng = np.random.default_rng(3)
    idx = np.unique(rng.integers(0, 1000, size=(768, 2)), axis=0)
    worker, front = _fleet(pk, _recording(worker_rows, lock),
                           _recording(local_rows, lock))
    with worker, front:
        front.register_worker(worker.address)
        with _client(pk, front.address, "parity") as o:
            o.bind_sizes((1000, 1000))
            got = _label(pk, o, idx)
        stats = front.service.stats()
        worker_stats = worker.service.stats()
    return {"rows": len(idx), "worker": worker_rows, "local": local_rows,
            "right": bool((got == idx.sum(1) % 2).all()), "stats": stats,
            "worker_stats": worker_stats}


def test_super_batches_shard_across_worker_hosts():
    """A front server with a registered worker host splits each super-batch
    across hosts; results are bit-identical to local-only execution."""
    port, ref = _both(_sharded)
    assert port["right"]
    # both hosts worked
    assert sum(port["worker"]) > 0 and sum(port["local"]) > 0
    assert sum(port["worker"]) + sum(port["local"]) == port["rows"]
    assert port["stats"]["remote_shards"] >= 1
    assert port == ref


def _splits(pk):
    svc = pk.svc.OracleService(workers=2, max_wait_ms=WAIT)
    try:
        idx = np.arange(1000)
        out = []
        # nothing measured yet -> uniform
        out.append(svc._capacity_split(idx, ["a", "local"]))
        svc._record_rate("a", 100, 1.0)       # 100 rows/s
        svc._record_rate("local", 300, 1.0)   # 300 rows/s
        out.append(svc._capacity_split(idx, ["a", "local"]))
        # an unmeasured executor is assigned the mean measured rate
        out.append(svc._capacity_split(idx, ["a", "b", "local"]))
        # one-row floor: a very slow executor still gets a shard
        svc._record_rate("crawl", 1, 1000.0)  # 0.001 rows/s
        out.append(svc._capacity_split(idx, ["crawl", "local"]))
    finally:
        svc.close()
    return [[p.tolist() for p in parts] for parts in out]


def test_capacity_split_proportions_and_order():
    """The capacity-weighted split is contiguous, order-preserving, sized in
    proportion to measured rows/s EWMAs (mean-rate fallback for unmeasured
    executors, uniform when nothing is measured), and never emits an empty
    shard."""
    port, ref = _both(_splits)
    sizes = [[len(p) for p in parts] for parts in port]
    for parts in port:
        assert sum(parts, []) == list(range(1000))   # contiguous, in order
    assert sizes[0] == [500, 500]
    assert sizes[1] == [250, 750]
    assert sum(sizes[2]) == 1000
    assert abs(sizes[2][1] - 1000 * 200 / 600) <= 1
    assert sizes[2][0] < sizes[2][1] < sizes[2][2]
    assert sizes[3] == [1, 999]
    assert port == ref


def _slow_worker(pk):
    worker_shards, local_shards = [], []
    lock = threading.Lock()
    rng = np.random.default_rng(7)
    idx1 = np.unique(rng.integers(0, 1000, size=(640, 2)), axis=0)
    idx2 = np.unique(rng.integers(1000, 2000, size=(640, 2)), axis=0)
    worker, front = _fleet(pk, _recording(worker_shards, lock),
                           _recording(local_shards, lock))
    with worker, front:
        svc = front.service
        front.register_worker(worker.address)
        label = svc._worker_label(svc._remote_workers[0])
        with _client(pk, front.address, "parity") as o:
            o.bind_sizes((2000, 2000))
            got1 = _label(pk, o, idx1)        # uniform warm-up round
            rates = {label: pk.wire.ThroughputEWMA(),
                     "local": pk.wire.ThroughputEWMA()}
            rates[label].update(100, 1.0)     # 100 rows/s
            rates["local"].update(10_000, 1.0)
            with svc._stats_lock:
                svc._shard_rates = rates
            snap = svc.snapshot()
            got2 = _label(pk, o, idx2)        # capacity-weighted round
        stats = svc.stats()
    # the rates back the snapshot surface; the host's label names its port
    snap_rates = {k.replace(label, "worker"): v for k, v in snap.items()
                  if k.startswith("service.shard.rate.")}
    return {"rows": (len(idx1), len(idx2)),
            "right": (bool((got1 == idx1.sum(1) % 2).all()),
                      bool((got2 == idx2.sum(1) % 2).all())),
            "worker": worker_shards, "local": local_shards,
            "rates": snap_rates, "stats": stats}


def test_slow_worker_host_gets_smaller_shard_bit_identical():
    """Capacity-weighted sharding: after a uniform warm-up round, a worker
    host measured ~100x slower than the local pool receives a
    proportionally smaller shard — and because the split is contiguous and
    order-preserving, labels stay bit-identical to the reference.  The
    slowness is injected: the executors' rows/s EWMAs are set directly."""
    port, ref = _both(_slow_worker)
    n1, n2 = port["rows"]
    worker, local = port["worker"], port["local"]
    assert port["right"] == (True, True)
    assert len(worker) == 2 and len(local) == 2
    # warm-up split evenly; the weighted round shrinks the slow host's share
    assert abs(worker[0] - n1 // 2) <= 1
    assert worker[1] < worker[0]
    assert worker[1] < n2 // 2 < local[1]
    assert worker[1] + local[1] == n2
    assert abs(worker[1] - n2 * 100 / 10_100) <= 1
    # the rates back the snapshot surface: slow host measured slower
    assert port["rates"] == {"service.shard.rate.worker": 100.0,
                             "service.shard.rate.local": 10_000.0}
    assert port == ref


_WORKER_KEYS = ("service.worker.live", "service.worker.dead",
                "service.worker.deaths", "service.worker.rejoins")


def _workers(snap):
    return tuple(snap[k] for k in _WORKER_KEYS)


def _dead_worker(pk):
    worker, front = _fleet(pk, _parity_fn, _parity_fn)
    try:
        front.register_worker(worker.address)
        worker.close()                               # host dies after joining
        rng = np.random.default_rng(4)
        idx = np.unique(rng.integers(0, 1000, size=(512, 2)), axis=0)
        with _client(pk, front.address, "parity") as o:
            o.bind_sizes((1000, 1000))
            got = _label(pk, o, idx)
        return (bool((got == idx.sum(1) % 2).all()), front.service.stats(),
                _workers(front.service.snapshot()))
    finally:
        front.close()


def test_dead_worker_host_degrades_to_local_execution():
    """A worker host that died is unregistered on its first failed shard;
    the shard falls back to local execution — a dead worker costs
    throughput, never a query (a health check would re-register it if the
    host came back; see test_worker_health_check_reregistration)."""
    port, ref = _both(_dead_worker)
    right, stats, workers = port
    assert right
    assert stats["remote_failures"] >= 1
    assert workers == (0.0, 1.0, 1.0, 0.0)           # live, dead, deaths, ...
    assert port == ref


def _health(pk):
    worker, front = _fleet(pk, _parity_fn, _parity_fn)
    port = worker.address[1]
    steps = []
    try:
        svc = front.service
        front.register_worker(worker.address)
        steps.append(_workers(svc.snapshot()))
        worker.close()                               # host dies

        pk.check(svc)                  # its ping fails: marked dead
        steps.append(_workers(svc.snapshot()))

        rng = np.random.default_rng(11)
        idx = np.unique(rng.integers(0, 1000, size=(512, 2)), axis=0)
        with _client(pk, front.address, "parity") as o:
            o.bind_sizes((1000, 1000))
            during = _label(pk, o, idx)              # all-local while dead
        during_stats = svc.stats()

        # host restarts on the same port -> the next check re-registers it
        worker = pk.wire.OracleServiceServer(
            {"parity": _parity_fn}, port=port, max_wait_ms=WAIT,
            health_check_s=0)
        pk.check(svc)
        steps.append(_workers(svc.snapshot()))

        with _client(pk, front.address, "parity") as o:
            o.bind_sizes((1000, 1000))
            after = _label(pk, o, idx)
        return {"right": bool((during == idx.sum(1) % 2).all()),
                "same": bool((after == during).all()), "steps": steps,
                "stats": (during_stats, svc.stats())}
    finally:
        worker.close()
        front.close()


def test_worker_health_check_reregistration():
    """A worker host that dies is marked dead by a health check; when it
    comes back on the same port the next check re-registers it (groups
    re-fetched), shards route remotely again, and labels are bit-identical
    across the death/rejoin cycle.  Each check is one explicit sweep."""
    port, ref = _both(_health)
    # (live, dead, deaths, rejoins): joined, dead after a check, rejoined
    assert port["steps"] == [(1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 1.0, 0.0),
                             (1.0, 0.0, 1.0, 1.0)]
    assert port["right"]                             # all-local while dead
    assert port["same"]                              # bit-identical
    during, after = port["stats"]
    assert during["remote_failures"] == 0            # never routed to it
    # shards flow to the rejoined host again
    assert after["remote_shards"] > during["remote_shards"]
    assert port == ref


# ----------------------------------------------------------------------------
# deadline-based admission control
# ----------------------------------------------------------------------------

def _gated(gate):
    """A backend held on ``gate``: its window stays in flight (the backlog
    admission control sees) until the test releases it."""
    def fn(idx):
        assert gate.wait(timeout=BOUND), "the gate was never opened"
        return _parity_fn(idx)
    return fn


def _admission(pk):
    tight, lax = _parity_oracle(pk, 10_000), _parity_oracle(pk, 10_000)
    tracker = pk.obs.InMemoryTracker()
    gate = threading.Event()
    out = {}
    with pk.svc.OracleService(workers=1, max_wait_ms=5.0, min_shard=1 << 30,
                              tracker=tracker) as svc:
        svc.attach(tight, deadline_ms=100.0, query_class="tight")
        svc.attach(lax)

        # warmup: admitted (no rate measured yet) and establishes the EWMA
        warm = np.stack([np.arange(100), np.arange(100) + 1], axis=1)
        out["warm"] = (_label(pk, tight, warm).tolist() == _parity_fn(
            warm).tolist(), tight.calls)
        _until(svc, lambda: svc._inflight_rows == 0)  # rates folded in
        out["measured"] = svc.snapshot()["service.rate_rows_per_s"] > 0.0
        with svc._cv:
            svc._class_rates["tight"] = 10_000.0     # rows/s

        # saturate: an 8000-row raw backlog -> predicted wait ~0.8 s
        big = np.stack([np.arange(8000), np.arange(8000) + 1], axis=1)
        bulk = svc.submit_raw("bulk", _gated(gate), big)

        small = np.array([[5001, 2], [5002, 7]])  # not in warm (uncached)
        before = (tight.calls, tight.charged)
        with pytest.raises(pk.svc.AdmissionRejected) as ei:
            _label(pk, tight, small)                 # predicted >> 100 ms
        e = ei.value
        out["rejected"] = (e.retryable, e.qclass, e.deadline_ms,
                           e.predicted_ms, e.queue_rows)
        out["untouched"] = (tight.calls, tight.charged) == before

        # the deadline-free client rides out the same backlog un-shed
        lax_batch = pk.core.OracleBatch(lax)
        lax_handle = lax_batch.submit(small)
        lax_flush = lax_batch.flush_async()          # admitted, queued
        gate.set()                                   # the backlog drains
        lax_flush.result(timeout=BOUND)
        out["lax"] = (lax_handle.labels.tolist(), lax.calls)

        # recovery: after the backlog drains the same flush is admitted
        out["bulk"] = bulk.result(timeout=BOUND).tolist() == _parity_fn(
            big).tolist()
        _until(svc, lambda: svc._queued_rows + svc._inflight_rows == 0)
        out["recovered"] = (_label(pk, tight, small).tolist(),
                            tight.calls - before[0])
        snap = svc.snapshot()
        out["snap"] = (snap["service.admission.rejected"],
                       snap["service.admission.rejected.events"],
                       "service.class.tight.flush_ms.p50" in snap)
    out["default_class"] = tracker.histogram(
        "service.class.default.flush_ms") is not None
    return out


def test_admission_sheds_only_over_deadline_class_and_never_charges():
    """Under a saturated queue, only flushes whose declared deadline the
    predicted wait would miss are shed — with a typed, retryable error and
    zero ledger movement.  Deadline-free clients are never shed, and the
    shed client succeeds on retry once the backlog drains.  The backlog is
    a raw segment held in flight on an event, and the class's rate is set:
    the predicted wait is (8,002 rows / 10,000 rows/s) + 5 ms."""
    port, ref = _both(_admission)
    assert port["warm"] == (True, 100)
    assert port["measured"]
    retryable, qclass, deadline_ms, predicted_ms, queue_rows = port["rejected"]
    assert retryable is True
    assert qclass == "tight"
    assert deadline_ms == 100.0
    assert predicted_ms == pytest.approx(1e3 * (8000 + 2) / 10_000.0 + 5.0)
    assert queue_rows >= 8000
    assert port["untouched"]                         # zero ledger movement
    assert port["lax"] == ([1.0, 1.0], 2)
    assert port["bulk"]
    assert port["recovered"] == ([1.0, 1.0], 2)
    assert port["snap"] == (1.0, 1.0, True)
    assert port["default_class"]
    assert port == ref


def _slow_class(pk):
    slow = pk.core.FnOracle(lambda idx: np.ones(len(idx)))
    fast = pk.core.FnOracle(lambda idx: np.ones(len(idx)))
    slow.bind_sizes((10_000, 10_000))
    fast.bind_sizes((10_000, 10_000))
    gate = threading.Event()
    with pk.svc.OracleService(workers=1, max_wait_ms=5.0,
                              min_shard=1 << 30) as svc:
        svc.attach(slow, deadline_ms=60_000.0, query_class="slow")
        svc.attach(fast, deadline_ms=100.0, query_class="fast")

        # the slow class measures a rate into its own EWMA, then is made slow
        warm = np.stack([np.arange(2000), np.arange(2000) + 1], axis=1)
        _label(pk, slow, warm)
        _until(svc, lambda: svc._inflight_rows == 0)  # rates folded in
        with svc._cv:
            svc._service_rate = 10_000.0
            svc._class_rates["slow"] = 10_000.0
            global_rate = svc._service_rate

        # a backlog that, at the slow class's rate, predicts far beyond the
        # fast class's 100 ms deadline
        big = np.stack([np.arange(6000), np.arange(6000) + 1], axis=1)
        bulk = svc.submit_raw("bulk", _gated(gate), big)

        small = np.array([[7001, 2], [7002, 7]])
        with svc._cv:
            backlog = svc._queued_rows + svc._inflight_rows + len(small)
        batch = pk.core.OracleBatch(fast)
        handle = batch.submit(small)
        flush = batch.flush_async()  # per-class rate: fast is unmeasured ->
        gate.set()                   # admitted
        flush.result(timeout=BOUND)
        bulk.result(timeout=BOUND)
        _until(svc, lambda: svc._inflight_rows == 0)
        snap = svc.snapshot()
    return {"global_ms": 1e3 * backlog / global_rate,
            "fast": (handle.labels.tolist(), _ledger(fast)),
            "slow": _ledger(slow),
            "measured": (snap["service.class.slow.rate_rows_per_s"] > 0.0,
                         snap["service.class.fast.rate_rows_per_s"] > 0.0),
            "rejected": snap["service.admission.rejected"]}


def test_slow_class_cannot_shed_fast_class():
    """Per-deadline-class admission budgets: each class predicts its wait
    from its OWN measured EWMA rate.  Regression for the single global-rate
    design, under which a slow tenant's measurements inflated the predicted
    wait of a fast tenant enough to shed it.  The slow class's rate (and
    the global one) are set to 10,000 rows/s; the backlog is held in flight
    on an event."""
    port, ref = _both(_slow_class)
    # the retired global-rate design would have shed the fast class here
    assert port["global_ms"] > 100.0
    labels, ledger = port["fast"]
    assert labels == [1.0, 1.0] and ledger[0] == 2
    assert port["measured"] == (True, True)
    assert port["rejected"] == 0.0
    assert port == ref
