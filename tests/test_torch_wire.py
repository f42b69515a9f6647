"""The serving plane across the two packages: the port's transport and label
persistence against the reference's (``repro.serve.transport``,
``repro.checkpoint.label_io``).

- A port :class:`RemoteOracle` against a reference
  :class:`OracleServiceServer`, and a reference client against a port
  server: each query gives exactly the estimate, CI and ledger of the same
  query labelling in process in its own package.  A worker host of one
  package serves a front server of the other.
- :class:`LabelRequest` / :class:`LabelResult` payloads and whole frames are
  the same bytes in both packages, and each decodes the other's.
- A label segment (and a whole :class:`LabelStore`) saved by either package
  loads in the other with the same digest and values.

Windows close by presence (``max_wait_ms=WAIT``), every blocking wait is
bounded, servers bind port 0, and no thread outlives its test.
"""
import socket
import threading

import numpy as np
import pytest

import repro.checkpoint.label_io as R_io
import repro.core as R
import repro.core.oracle as R_oracle
import repro.data as RD
import repro.serve.label_store as R_store
import repro.serve.transport as R_wire
import repro_torch.checkpoint.label_io as P_io
import repro_torch.core as P
import repro_torch.core.oracle as P_oracle
import repro_torch.data as PD
import repro_torch.serve.label_store as P_store
import repro_torch.serve.transport as P_wire

WAIT = 60_000.0     # ms: windows close by presence, never by this timer
BOUND = 30.0        # s: every blocking wait in these tests
PACKAGES = {"port": (P, PD, P_wire), "reference": (R, RD, R_wire)}


@pytest.fixture(autouse=True)
def no_leftover_threads():
    """Every server and connection a test opens is closed by its end: no
    thread it started may survive it."""
    before = set(threading.enumerate())
    yield
    new = [t for t in threading.enumerate() if t not in before]
    for t in new:
        t.join(timeout=BOUND)
    alive = [t.name for t in new if t.is_alive()]
    assert not alive, f"threads outlived the test: {alive}"


def _run_bas(core, q):
    kw = {"device": "cpu"} if core is P else {}
    return core.run_bas(q, seed=11, **kw)


@pytest.mark.parametrize("client,server", [("port", "reference"),
                                           ("reference", "port")])
def test_remote_query_across_packages_equals_in_process(client, server):
    """The client package's BAS query labelling through the other package's
    loopback server equals the same query labelling in process: estimate,
    CI and ledger, exactly."""
    core, data, wire = PACKAGES[client]
    srv_wire = PACKAGES[server][2]
    ds = data.make_clustered_tables(80, 80, n_entities=120, noise=0.4, seed=11)
    local = ds.oracle()
    ref = _run_bas(core, core.Query(spec=ds.spec(), agg=core.Agg.COUNT,
                                    oracle=local, budget=1200))

    with srv_wire.OracleServiceServer({"truth": local._label},
                                      max_wait_ms=WAIT) as srv:
        with wire.RemoteOracle(srv.address, "truth", timeout_s=BOUND,
                               retries=0) as remote:
            got = _run_bas(core, core.Query(spec=ds.spec(), agg=core.Agg.COUNT,
                                            oracle=remote, budget=1200))
        stats = srv.service.stats()
    assert got.estimate == ref.estimate
    assert got.ci.lo == ref.ci.lo and got.ci.hi == ref.ci.hi
    assert (remote.calls, remote.requests, remote.batches, remote.charged) == (
        local.calls, local.requests, local.batches, local.charged)
    assert stats["rows_labelled"] == local.calls     # the server executed all


@pytest.mark.parametrize("worker,front", [("port", "reference"),
                                          ("reference", "port")])
def test_worker_host_serves_the_other_packages_front(worker, front):
    """A front server shards a super-batch over a worker host of the other
    package (its GROUPS handshake and EXECs cross the packages); the labels
    equal local execution."""
    rng = np.random.default_rng(3)
    idx = np.unique(rng.integers(0, 1000, size=(768, 2)), axis=0)
    parity = lambda i: (i.sum(axis=1) % 2).astype(np.float64)  # noqa: E731
    w = PACKAGES[worker][2].OracleServiceServer(
        {"parity": parity}, max_wait_ms=WAIT, health_check_s=0)
    f = PACKAGES[front][2].OracleServiceServer(
        {"parity": parity}, max_wait_ms=WAIT, workers=1, min_shard=64,
        health_check_s=0)
    with w, f:
        f.register_worker(w.address)
        with PACKAGES[front][2].ServiceConnection(
                f.address, announce=True, timeout_s=BOUND, retries=0) as conn:
            got = conn.execute("parity", idx)
        front_stats, worker_stats = f.service.stats(), w.service.stats()
    np.testing.assert_array_equal(got, idx.sum(1) % 2)
    assert front_stats["remote_shards"] == 1
    assert 0 < worker_stats["rows_labelled"] < len(idx)


def test_label_payload_bytes_equal_both_ways():
    idx = np.array([[1, 2], [3, 4], [5, 6]])
    labels = np.array([1.0, 0.0, 1.0])
    for a, b in ((P_oracle, R_oracle), (R_oracle, P_oracle)):
        req = a.LabelRequest("pairs", idx, request_id=42).to_bytes()
        assert req == b.LabelRequest("pairs", idx, request_id=42).to_bytes()
        got = b.LabelRequest.from_bytes(req)
        assert (got.group, got.request_id) == ("pairs", 42)
        np.testing.assert_array_equal(got.idx, idx)
        res = a.LabelResult(request_id=42, labels=labels).to_bytes()
        assert res == b.LabelResult(request_id=42, labels=labels).to_bytes()
        np.testing.assert_array_equal(b.LabelResult.from_bytes(res).labels,
                                      labels)
        err = a.LabelResult(request_id=7, error="RuntimeError: boom").to_bytes()
        assert b.LabelResult.from_bytes(err).error == "RuntimeError: boom"
        empty = a.LabelRequest("g", np.empty((0, 3), np.int64)).to_bytes()
        assert b.LabelRequest.from_bytes(empty).idx.shape == (0, 3)


def test_frames_equal_both_ways():
    """A frame written by either package is the same bytes and reads back
    in the other."""
    payload = P_oracle.LabelRequest("g", np.array([[7, 8]]), 3).to_bytes()
    codes = ("MSG_EXEC", "MSG_RESULT", "MSG_ERROR", "MSG_PING", "MSG_PONG",
             "MSG_GROUPS", "MSG_GROUPS_OK", "MSG_HELLO")
    assert [getattr(P_wire, c) for c in codes] == [getattr(R_wire, c)
                                                   for c in codes]
    for a, b in ((P_wire, R_wire), (R_wire, P_wire)):
        sent = {}
        for name, wire in (("a", a), ("b", b)):
            w, r = socket.socketpair()
            with w, r:
                r.settimeout(BOUND)
                wire.send_frame(w, wire.MSG_EXEC, payload)
                w.shutdown(socket.SHUT_WR)
                sent[name] = r.recv(1 << 16)
        assert sent["a"] == sent["b"]
        w, r = socket.socketpair()
        with w, r:
            r.settimeout(BOUND)
            a.send_frame(w, a.MSG_GROUPS_OK, b"x\ny")
            assert b.recv_frame(r) == (b.MSG_GROUPS_OK, b"x\ny")


@pytest.mark.parametrize("writer,reader", [(P_io, R_io), (R_io, P_io)])
def test_label_segment_loads_across_packages(tmp_path, writer, reader):
    key = (("scorer", "joinml-oracle", 0.5), ("sizes", 256, 256))
    keys = np.array([3, 17, 65535], np.int64)
    vals = np.array([1.0, 0.0, 1.0])
    assert writer.segment_digest(key) == reader.segment_digest(key)
    path = writer.save_segment(str(tmp_path), key, keys, vals)
    assert path.endswith(reader.segment_digest(key))
    ((got_key, got_keys, got_vals),) = reader.load_segments(str(tmp_path))
    assert got_key == key
    np.testing.assert_array_equal(got_keys, keys)
    np.testing.assert_array_equal(got_vals, vals)


@pytest.mark.parametrize("writer,reader", [(P_store, R_store),
                                           (R_store, P_store)])
def test_label_store_saved_by_one_package_serves_the_other(tmp_path, writer,
                                                           reader):
    """A store saved under a root by one package hydrates in the other: the
    same named scorer group's keys are hits with the saved values."""
    seg = (("scorer", "joinml-oracle", 0.5), ("sizes", 64, 64))
    store = writer.LabelStore(root=str(tmp_path))
    keys = np.array([10, 20, 30], np.int64)
    plan = store.plan(seg, keys)
    store.publish(plan, np.array([0.0, 1.0, 1.0]))
    assert store.save() == 1
    revived = reader.LabelStore(root=str(tmp_path))
    assert revived.loads == 1
    plan = revived.plan(seg, keys)
    assert len(plan.miss_keys) == 0
    np.testing.assert_array_equal(plan.hit_vals, [0.0, 1.0, 1.0])
    assert P_store.persistable_key(seg) and R_store.persistable_key(seg)
