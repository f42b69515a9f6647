"""The port's shared label store (``repro_torch.serve.label_store``):
charge-once oracle caching across queries, held against the reference's
(``repro.serve.label_store``).  Mirrors ``tests/test_label_store.py`` case
for case, with the same counters and labels.

The contract under test: attaching a :class:`LabelStore` to an
:class:`OracleService` changes *who pays* for a label (first requester;
everyone else rides free via ``store_hits``) but nothing about *what* any
query computes — ``calls`` advances exactly as in serial execution, so
estimates stay bit-identical, while summed ``charged`` is bounded by the
number of distinct pairs ever labelled.

Each case runs the same sequence through both packages and asserts equal
``stats()``, ``snapshot()``, ledgers and labels.  Estimates of the two
packages' BAS agree to ``rel=1e-6`` (``tests/test_torch_bas.py``); within a
package they are bit-identical.

As in ``test_torch_oracle_service.py``: windows that gather several clients
close by presence (``max_wait_ms=WAIT``, 60 s), every blocking wait is
bounded, servers bind port 0, and no service thread outlives its test.
"""
import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R_core
import repro.data as R_data
import repro.serve.label_store as R_store
import repro.serve.oracle_service as R_svc
import repro.serve.transport as R_wire
import repro_torch.core as P_core
import repro_torch.data as P_data
import repro_torch.serve.label_store as P_store
import repro_torch.serve.oracle_service as P_svc
import repro_torch.serve.transport as P_wire

WAIT = 60_000.0     # ms: windows close by presence, never by this timer
BOUND = 30.0        # s: every blocking wait in these tests
REL = 1e-6          # the port's BAS against the reference's

P = SimpleNamespace(core=P_core, data=P_data, store=P_store, svc=P_svc,
                    wire=P_wire, run_kw={"device": "cpu"})
R = SimpleNamespace(core=R_core, data=R_data, store=R_store, svc=R_svc,
                    wire=R_wire, run_kw={})


@pytest.fixture(autouse=True)
def no_leftover_threads():
    """Every service and server a test opens is closed by its end: no thread
    it started may survive it."""
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


def _label(pk, oracle, idx):
    """``oracle.label(idx)`` with a bounded wait on the flush."""
    batch = pk.core.OracleBatch(oracle)
    handle = batch.submit(idx)
    batch.flush_async().result(timeout=BOUND)
    return handle.labels


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
    for t in threads:
        t.join(timeout=BOUND)
    assert not any(t.is_alive() for t in threads), "a flush never finished"
    return outcomes


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


def _counting_scorer(rows):
    """Deterministic pair scorer that records every row it executes."""
    lock = threading.Lock()

    def scorer(idx):
        with lock:
            rows.append(np.array(idx))
        return ((idx[:, 0] * 31 + idx[:, 1]) % 97 / 96.0).astype(np.float64)

    return scorer


def _ledger(o):
    return (o.calls, o.requests, o.batches, o.charged, o.store_hits,
            o.store_charge_saved)


# ----------------------------------------------------------------------------
# charge-once accounting
# ----------------------------------------------------------------------------

def _identical_pairs(pk):
    rows = []
    scorer = _counting_scorer(rows)
    a = pk.core.ModelOracle(scorer, threshold=0.5)
    b = pk.core.ModelOracle(scorer, threshold=0.5)
    for o in (a, b):
        o.bind_sizes((64, 64))
    store = pk.store.LabelStore()
    idx = np.array([[3, 4]])
    with pk.svc.OracleService(max_wait_ms=WAIT, label_store=store) as svc:
        svc.attach(a, b)
        ba, bb = pk.core.OracleBatch(a), pk.core.OracleBatch(b)
        ha, hb = ba.submit(idx), bb.submit(idx)
        out = _flush_concurrently([ba, bb])
    # which of the two pays depends on which flush queued first: sums only
    return {"out": out, "executed": sum(len(r) for r in rows),
            "labels": (ha.labels.tolist(), hb.labels.tolist()),
            "calls": (a.calls, b.calls),
            "charged": a.charged + b.charged,
            "store_hits": a.store_hits + b.store_hits,
            "saved": a.store_charge_saved + b.store_charge_saved,
            "service": svc.stats(), "store": store.snapshot()}


def test_concurrent_identical_pairs_charge_once():
    """Two queries racing on the same uncached pair in one window: exactly
    one backend execution, one total charge — and both oracles' ``calls``
    advance as in serial execution (the budget guarantee is untouched)."""
    port, ref = _both(_identical_pairs)
    assert port["service"]["windows"] == 1          # one window, by presence
    assert port["out"] == [None, None]
    assert port["executed"] == 1                     # one backend execution
    assert port["labels"][0] == port["labels"][1]
    assert port["calls"] == (1, 1)                   # pacing as in serial
    assert port["charged"] == 1                      # ...but one charge total
    assert port["store_hits"] == 1
    assert port["saved"] == 1
    assert port["service"]["store_shared"] == 1
    assert port["service"]["store_misses"] == 1
    assert port == ref


def _repeat_query(pk):
    rows = []
    scorer = _counting_scorer(rows)
    store = pk.store.LabelStore()
    idx = np.array([[0, 1], [2, 3], [4, 5]])
    with pk.svc.OracleService(max_wait_ms=WAIT, label_store=store) as svc:
        first = pk.core.ModelOracle(scorer, threshold=0.5)
        first.bind_sizes((64, 64))
        svc.attach(first)
        _label(pk, first, idx)
        svc.detach(first)
        first_ledger = _ledger(first)

        again = pk.core.ModelOracle(scorer, threshold=0.5)
        again.bind_sizes((64, 64))
        svc.attach(again)
        got = _label(pk, again, idx)
        svc.detach(again)
    return {"executed": sum(len(r) for r in rows), "got": got.tolist(),
            "want": first.label(idx).tolist(), "first": first_ledger,
            "again": _ledger(again), "service": svc.stats(),
            "store": store.snapshot()}


def test_repeat_query_served_from_store_without_recharge():
    """A later query (fresh oracle, same scorer group) repeating already-
    stored pairs executes nothing and charges nothing."""
    port, ref = _both(_repeat_query)
    calls, _, _, charged, hits, _ = port["first"]
    assert charged == 3 and hits == 0
    assert port["executed"] == 3                     # only the first paid
    assert port["got"] == port["want"]
    calls, _, _, charged, hits, _ = port["again"]
    assert calls == 3                                # acquired, as in serial
    assert charged == 0 and hits == 3
    assert port["service"]["store_hit_rate"] == 0.5
    assert port["service"]["store_entries"] == 3
    assert port == ref


def _bounded_charges(pk):
    ds = pk.data.make_clustered_tables(60, 60, n_entities=90, noise=0.4,
                                       seed=21)
    rows = []
    scorer = _counting_scorer(rows)

    def fresh_query():
        o = pk.core.ModelOracle(scorer, threshold=0.5, name="shared")
        return pk.core.Query(spec=ds.spec(), agg=pk.core.Agg.COUNT, oracle=o,
                             budget=700)

    ref_q = fresh_query()
    ref = pk.core.run_bas(ref_q, seed=9, **pk.run_kw)
    rows.clear()

    store = pk.store.LabelStore()
    results, oracles = [], []
    with pk.svc.OracleService(max_wait_ms=WAIT, label_store=store) as svc:
        for _ in range(3):                           # 1 first + 2 repeats
            q = fresh_query()
            oracles.append(q.oracle)
            svc.attach(q.oracle)
            results.append(pk.core.run_bas(q, seed=9, **pk.run_kw))
            svc.detach(q.oracle)
    return {"serial": (ref.estimate, ref.ci.lo, ref.ci.hi),
            "served": [(r.estimate, r.ci.lo, r.ci.hi) for r in results],
            "exact": {"serial_ledger": _ledger(ref_q.oracle),
                      "ledgers": [_ledger(o) for o in oracles],
                      "executed": sum(len(r) for r in rows),
                      "store_telemetry": [(r.telemetry.store.hits,
                                           r.telemetry.store.charge_saved)
                                          for r in results],
                      "service": svc.stats(), "store": store.snapshot()}}


def test_estimates_bit_identical_and_total_charges_bounded():
    """Full BAS queries through a stored service: estimates and CIs are
    bit-identical to serial execution, a repeat query charges zero, and the
    summed ledger charge equals the store's distinct-pair count — the
    acceptance bound.  The reference's run gives the same ledgers and store
    counters, and its estimates to ``REL``."""
    port, ref = _both(_bounded_charges)
    ex = port["exact"]
    serial_calls = ex["serial_ledger"][0]
    for served, (calls, *_rest) in zip(port["served"], ex["ledgers"]):
        assert served == port["serial"]              # bit-identical
        assert calls == serial_calls                 # pacing unchanged
    charged = [ledger[3] for ledger in ex["ledgers"]]
    assert charged[0] == serial_calls                # first requester pays
    assert charged[1] == 0 and charged[2] == 0       # repeats ride free
    # the acceptance bound: total charges == distinct pairs ever labelled
    assert sum(charged) == ex["service"]["store_entries"]
    assert ex["executed"] == sum(charged)
    # the discount is surfaced per query result
    assert ex["store_telemetry"][1][0] == ex["ledgers"][1][0]
    assert ex["store_telemetry"][1][1] > 0
    assert ex == ref["exact"]
    assert np.ravel(port["served"]) == pytest.approx(np.ravel(ref["served"]),
                                                     rel=REL, abs=1e-9)


# ----------------------------------------------------------------------------
# memory budget: LRU segment eviction + single-segment trim
# ----------------------------------------------------------------------------

def _fill(store, seg_key, keys, val=1.0):
    keys = np.asarray(sorted(keys), np.int64)
    plan = store.plan(seg_key, keys)
    store.publish(plan, np.full(len(plan.miss_keys), val))


def _lru(pk):
    # 24 bytes/entry (key + val + gen): budget for ~40 entries
    store = pk.store.LabelStore(max_bytes=40 * 24)
    for g in range(5):
        _fill(store, ("seg", g), range(g * 100, g * 100 + 20))
    return {"bytes": (store.bytes_resident, store.max_bytes),
            "resident": [store.resident(("seg", g),
                                        np.arange(g * 100, g * 100 + 20)
                                        ).tolist() for g in range(5)],
            "stats": store.stats(), "snapshot": store.snapshot()}


def test_lru_segment_eviction_under_pressure():
    port, ref = _both(_lru)
    resident, max_bytes = port["bytes"]
    assert resident <= max_bytes
    assert port["stats"]["store_evictions"] >= 1
    # the newest (hot) segment survives; the LRU-oldest was evicted
    assert all(port["resident"][4])
    assert not any(port["resident"][0])
    assert port == ref


def _trim(pk):
    store = pk.store.LabelStore(max_bytes=30 * 24)
    _fill(store, ("only",), range(0, 20))            # oldest generation
    _fill(store, ("only",), range(100, 120))
    _fill(store, ("only",), range(200, 220))         # newest generation
    return {"bytes": (store.bytes_resident, store.max_bytes),
            "resident": [store.resident(("only",),
                                        np.arange(g, g + 20)).tolist()
                         for g in (0, 100, 200)],
            "stats": store.stats(), "snapshot": store.snapshot()}


def test_lone_over_budget_segment_trims_its_oldest_half():
    port, ref = _both(_trim)
    resident, max_bytes = port["bytes"]
    assert resident <= max_bytes
    assert port["stats"]["store_evictions"] == 0     # nothing else to evict
    assert port["stats"]["store_trimmed"] >= 20
    # oldest-inserted entries went first; the newest batch is untouched
    assert all(port["resident"][2])
    assert not any(port["resident"][0])
    assert port == ref


def _cancel(pk):
    store = pk.store.LabelStore()
    keys = np.array([1, 2, 3], np.int64)
    plan = store.plan(("seg",), keys)
    waiter = store.plan(("seg",), keys)              # rides plan's call
    rode = (len(waiter.miss_keys), len(waiter.wait))
    store.cancel(plan, RuntimeError("backend down"))
    with pytest.raises(RuntimeError, match="backend down"):
        waiter.wait[0][0].result(timeout=1.0)        # waiter fails retryably
    retry = store.plan(("seg",), keys)               # keys reservable again
    missed = retry.miss_keys.tolist()
    store.publish(retry, np.ones(3))
    return {"rode": rode, "retry_misses": missed,
            "resident": store.resident(("seg",), keys).tolist(),
            "stats": store.stats(), "snapshot": store.snapshot()}


def test_failed_plan_cancels_reservations_retryably():
    port, ref = _both(_cancel)
    assert port["rode"] == (0, 1)
    assert port["retry_misses"] == [1, 2, 3]
    assert all(port["resident"])
    assert port == ref


# ----------------------------------------------------------------------------
# persistence
# ----------------------------------------------------------------------------

def _persist(pk, root):
    store = pk.store.LabelStore(root=root)
    stable = (("scorer", "shared", 0.5), ("sizes", 64, 64))
    _fill(store, stable, [10, 20, 30], val=0.25)
    # an id()-derived (process-local) group coalesces in memory but must
    # never be persisted — its key is meaningless in another process
    local = pk.core.ModelOracle(lambda i: np.zeros(len(i)), threshold=0.5)
    local_key = (local.service_group(), ("sizes", 64, 64))
    _fill(store, local_key, [1, 2, 3])
    saved = store.save()                             # only the stable segment

    revived = pk.store.LabelStore(root=root)
    plan = revived.plan(stable, np.array([10, 20, 30], np.int64))
    return {"persistable": (pk.store.persistable_key(stable),
                            pk.store.persistable_key(local_key)),
            "saved": saved, "loads": revived.loads,
            "stable": revived.resident(stable,
                                       np.array([10, 20, 30])).tolist(),
            "local": revived.resident(local_key,
                                      np.array([1, 2, 3])).tolist(),
            "misses": len(plan.miss_keys), "hits": plan.hit_vals.tolist(),
            "stats": (store.stats(), revived.stats())}


def test_persistence_roundtrip_and_process_local_exclusion(tmp_path):
    port = _persist(P, str(tmp_path / "port"))
    ref = _persist(R, str(tmp_path / "reference"))
    assert port["persistable"] == (True, False)
    assert port["saved"] == 1
    assert port["loads"] == 1
    assert all(port["stable"]) and not any(port["local"])
    assert port["misses"] == 0
    assert port["hits"] == [0.25, 0.25, 0.25]
    assert port == ref


def _restart(pk, root):
    rows = []
    scorer = _counting_scorer(rows)
    idx = np.array([[1, 2], [3, 4], [5, 6]])
    with pk.svc.OracleService(
            max_wait_ms=WAIT, label_store=pk.store.LabelStore(root=root)) as svc:
        o = pk.core.ModelOracle(scorer, threshold=0.5, name="persisted")
        o.bind_sizes((64, 64))
        svc.attach(o)
        first = _label(pk, o, idx)
        svc.detach(o)
    # close() saved; a fresh service + store + oracle serves from disk
    with pk.svc.OracleService(
            max_wait_ms=WAIT, label_store=pk.store.LabelStore(root=root)) as svc2:
        o2 = pk.core.ModelOracle(scorer, threshold=0.5, name="persisted")
        o2.bind_sizes((64, 64))
        svc2.attach(o2)
        again = _label(pk, o2, idx)
        svc2.detach(o2)
    return {"first": first.tolist(), "again": again.tolist(),
            "executed": sum(len(r) for r in rows),
            "ledgers": (_ledger(o), _ledger(o2)),
            "stats": (svc.stats(), svc2.stats())}


def test_service_restart_keeps_hot_labels(tmp_path):
    """End to end: a named oracle's labels survive OracleService.close() ->
    new store -> new service; the repeat query executes zero backend rows."""
    port = _restart(P, str(tmp_path / "port"))
    ref = _restart(R, str(tmp_path / "reference"))
    assert port["again"] == port["first"]
    assert port["executed"] == 3                     # restart cost no charges
    _, _, _, charged, hits, _ = port["ledgers"][1]
    assert charged == 0 and hits == 3
    assert port == ref


# ----------------------------------------------------------------------------
# the transport (raw-segment) path
# ----------------------------------------------------------------------------

def _wire_exec(pk):
    rows = []
    lock = threading.Lock()

    def fn(idx):
        with lock:
            rows.append(np.array(idx))
        return (idx.sum(axis=1) % 2).astype(np.float64)

    idx = np.array([[5, 6], [1, 2], [5, 6], [3, 4]])  # unsorted + duplicate
    with pk.wire.OracleServiceServer({"parity": fn}, max_wait_ms=WAIT,
                                     label_store=pk.store.LabelStore()) as srv:
        with pk.wire.ServiceConnection(srv.address, timeout_s=BOUND,
                                       retries=0) as conn:
            got = conn.execute("parity", idx)
            executed_first = sum(len(r) for r in rows)
            _hang_up(conn)
        with pk.wire.ServiceConnection(srv.address, timeout_s=BOUND,
                                       retries=0) as conn2:
            again = conn2.execute("parity", idx[::-1])
            _hang_up(conn2)
        stats = srv.service.stats()
    return {"got": got.tolist(), "again": again.tolist(),
            "executed": (executed_first, sum(len(r) for r in rows)),
            "stats": stats}


def test_wire_exec_answers_are_store_served():
    """Raw EXEC segments go through the same store consultation: duplicate
    rows inside one request cost one execution, and a repeat request from
    another connection executes nothing."""
    port, ref = _both(_wire_exec)
    idx = np.array([[5, 6], [1, 2], [5, 6], [3, 4]])
    assert port["got"] == (idx.sum(1) % 2).tolist()
    assert port["again"] == (idx[::-1].sum(1) % 2).tolist()
    assert port["executed"] == (3, 3)                # unique rows; repeat: 0
    assert port["stats"]["store_hits"] >= 3
    assert port == ref


def test_pack_roundtrip_and_overflow_guard():
    idx = np.array([[0, 1], [2**31 - 1, 7], [123456, 654321]], np.int64)
    keys = P.store.pack_tuples(idx)
    np.testing.assert_array_equal(P.store.unpack_tuples(keys, 2), idx)
    assert P.store.pack_tuples(np.array([[2**31, 0]])) is None  # > 63//2 bits
    assert P.store.pack_tuples(np.array([[-1, 0]])) is None
    # the reference's keys, bit for bit, at two, three and four columns
    rng = np.random.default_rng(0)
    for k in (2, 3, 4):
        wide = rng.integers(0, 1 << (63 // k), size=(64, k), dtype=np.int64)
        keys = P.store.pack_tuples(wide)
        np.testing.assert_array_equal(keys, R.store.pack_tuples(wide))
        np.testing.assert_array_equal(P.store.unpack_tuples(keys, k),
                                      R.store.unpack_tuples(keys, k))
        over = wide.copy()
        over[0, 0] = 1 << (63 // k)
        assert R.store.pack_tuples(over) is None
        assert P.store.pack_tuples(over) is None
