"""The port's unified ``snapshot()`` surface and its OpenMetrics exporter
(``repro_torch.obs.prometheus``), held against the reference's
(``repro.obs.prometheus``).  Mirrors ``tests/test_obs.py:249-397``: the
stores' and the service's dotted snapshots, the launcher's per-class
histogram lines, the OpenMetrics rendering contract, and the exporter's HTTP
round trip and its 404.

Each case runs the same inputs through both packages and asserts the same
keys and values.  Only measured times differ between two runs: the
``*_ms`` histograms' mean and percentiles and the rows/s rates
(``TIMED``); their keys are still compared.

Services and exporters run with bounded waits, port 0, and no thread
outliving its test.
"""
import http.client
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R_core
import repro.launch.serve as R_launch
import repro.obs as R_obs
import repro.serve.label_store as R_store
import repro.serve.oracle_service as R_svc
import repro_torch.core as P_core
import repro_torch.launch.serve as P_launch
import repro_torch.obs as P_obs
import repro_torch.serve.label_store as P_store
import repro_torch.serve.oracle_service as P_svc

WAIT = 60_000.0     # ms: a solo client's window closes by presence
BOUND = 30.0        # s: every blocking wait in these tests

P = SimpleNamespace(core=P_core, obs=P_obs, store=P_store, svc=P_svc,
                    launch=P_launch, index_kw={"device": "cpu"})
R = SimpleNamespace(core=R_core, obs=R_obs, store=R_store, svc=R_svc,
                    launch=R_launch, index_kw={})


@pytest.fixture(autouse=True)
def no_leftover_threads():
    """Every service and exporter a test opens is closed by its end: no
    thread it started may survive it."""
    before = set(threading.enumerate())
    yield
    new = [t for t in threading.enumerate() if t not in before]
    for t in new:
        t.join(timeout=BOUND)
    alive = [t.name for t in new if t.is_alive()]
    assert not alive, f"threads outlived the test: {alive}"


def _timed(name):
    """A measured time or rate: differs between any two runs."""
    stat = name.rsplit(".", 1)[-1] if "." in name else name.rsplit("_", 1)[-1]
    return ("rate_rows_per_s" in name or "shard.rate" in name
            or "shard_rate" in name
            or ("_ms" in name and stat in ("mean", "p50", "p99", "max")))


def _untimed(snap):
    return {k: v for k, v in snap.items() if not _timed(k)}


def _agree(port, ref):
    """The same keys, and the same value under every key not measured."""
    assert sorted(port) == sorted(ref)
    assert _untimed(port) == _untimed(ref)


def _label(pk, oracle, idx):
    batch = pk.core.OracleBatch(oracle)
    handle = batch.submit(idx)
    batch.flush_async().result(timeout=BOUND)
    return handle.labels


def _until(svc, pred):
    """Wait, bounded, until ``pred()`` holds under the service's lock.  It
    re-checks every 10 ms: the reference's dispatcher does not notify the
    condition when a window ends."""
    end = time.monotonic() + BOUND
    with svc._cv:
        while not pred():
            assert time.monotonic() < end, "condition not met"
            svc._cv.wait(0.01)


def _get(address, path):
    """One GET on the loopback exporter (no proxy settings involved)."""
    host, port = address
    conn = http.client.HTTPConnection(host, port, timeout=BOUND)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


# ----------------------------------------------------------------------------
# the unified snapshot() surface
# ----------------------------------------------------------------------------

def _store_snapshots(pk, root):
    ls = pk.store.LabelStore()
    empty = ls.snapshot()
    keys = np.array([1, 2, 3], np.int64)
    ls.publish(ls.plan(("seg",), keys), np.ones(3))
    ls.plan(("seg",), keys)                       # three hits
    ix = pk.core.IndexStore(root=root, **pk.index_kw)
    return empty, ls.snapshot(), ix.snapshot()


def test_store_snapshots_use_dotted_namespaces(tmp_path):
    port = _store_snapshots(P, str(tmp_path / "port"))
    ref = _store_snapshots(R, str(tmp_path / "reference"))
    snap, used, ix = port
    assert "label_store.hit_rate" in snap
    assert "label_store.entries" in snap
    assert all(k.startswith("label_store.") for k in snap)
    assert all(isinstance(v, float) for v in snap.values())
    assert used["label_store.hits"] == 3.0
    assert "index_store.warm_hits" in ix
    assert all(k.startswith("index_store.") for k in ix)
    assert port == ref                            # keys and values


def _service_snapshot(pk):
    tracker = pk.obs.InMemoryTracker()
    with pk.svc.OracleService(max_wait_ms=WAIT,
                              label_store=pk.store.LabelStore(),
                              tracker=tracker) as svc:
        o = pk.core.FnOracle(
            lambda idx: (idx.sum(axis=1) % 2).astype(np.float64))
        o.bind_sizes((100, 100))
        svc.attach(o)
        _label(pk, o, np.array([[1, 2], [3, 4], [3, 4]]))
        svc.detach(o)
        _until(svc, lambda: svc._inflight_rows == 0)
        return svc.snapshot()


def test_service_snapshot_merges_tracker_stores_and_counters():
    snap = _service_snapshot(P)
    assert snap["service.windows"] >= 1.0
    assert snap["service.segments"] >= 1.0
    assert 0.0 < snap["service.window.fill_ratio_recent"] <= 1.0
    assert "service.window.dedup_ratio" in snap
    assert "label_store.hit_rate" in snap          # store merged in
    assert "service.window.assembly_ms.p50" in snap  # tracker series merged
    assert "service.shard.local_ms.p99" in snap
    assert "service.class.default.flush_ms.count" in snap
    assert all(isinstance(v, float) for v in snap.values())
    _agree(snap, _service_snapshot(R))


def _bare_snapshot(pk):
    with pk.svc.OracleService(max_wait_ms=WAIT) as svc:
        return svc.snapshot()


def test_noop_tracker_service_snapshot_still_has_base_keys():
    """snapshot() works without instrumentation: base counters and store
    namespaces are present even when the tracker records nothing."""
    snap = _bare_snapshot(P)
    assert snap["service.windows"] == 0.0
    assert snap["service.admission.rejected"] == 0.0
    assert snap["service.worker.live"] == 0.0
    assert not any(k.endswith(".p50") for k in snap)
    assert snap == _bare_snapshot(R)               # nothing measured: all equal


def _class_snapshot(pk):
    tracker = pk.obs.InMemoryTracker()
    with pk.svc.OracleService(max_wait_ms=WAIT, tracker=tracker) as svc:
        o = pk.core.FnOracle(lambda idx: np.ones(len(idx), np.float64))
        o.bind_sizes((100, 100))
        svc.attach(o, deadline_ms=60_000.0, query_class="tight")
        _label(pk, o, np.array([[1, 2], [3, 4]]))
        # the window's rate lands after its flush resolves
        _until(svc, lambda: svc._inflight_rows == 0)
        return svc.snapshot()


def test_launcher_prints_service_class_histograms(capsys):
    """The launcher shutdown print surfaces one line per deadline/query
    class, fed from the ``service.class.*`` snapshot keys an attached class
    generates (flush-latency percentiles + the per-class admission EWMA).
    Both launchers print the same lines from the same snapshot."""
    snap = _class_snapshot(P)
    # the attached class produced its snapshot keys...
    assert "service.class.tight.flush_ms.p50" in snap
    assert "service.class.tight.flush_ms.p99" in snap
    assert snap["service.class.tight.rate_rows_per_s"] > 0.0
    _agree(snap, _class_snapshot(R))
    # ...and the shutdown print renders them
    capsys.readouterr()
    P.launch._print_service_stats("service", snap)
    out = capsys.readouterr().out
    assert "class 'tight':" in out
    assert "p50=" in out and "p99=" in out and "rate=" in out
    R.launch._print_service_stats("service", snap)
    assert capsys.readouterr().out == out


# ----------------------------------------------------------------------------
# OpenMetrics exporter: snapshot() dicts -> Prometheus scrape surface
# ----------------------------------------------------------------------------

def test_render_openmetrics_contract():
    """Rendering mangles dotted names, types every sample as a gauge, drops
    non-finite values, and terminates with # EOF -- the reference's text,
    byte for byte, on the same snapshot."""
    snap = {
        "service.window.fill_ratio": 0.25,
        "service.shard.rate.127.0.0.1:9000": 1234.5,
        "label_store.hits": 7,
        "bad.value": float("nan"),
        "9starts.with.digit": 1.0,
    }
    body = P.obs.render_openmetrics(snap)
    assert body == R.obs.render_openmetrics(snap)
    assert (P.obs.render_openmetrics(snap, prefix="joinml")
            == R.obs.render_openmetrics(snap, prefix="joinml"))
    lines = body.splitlines()
    assert lines[-1] == "# EOF" and body.endswith("\n")
    assert "# TYPE repro_service_window_fill_ratio gauge" in lines
    assert "repro_service_window_fill_ratio 0.25" in lines
    # ':' survives (legal in prometheus names); '.' does not
    assert "repro_service_shard_rate_127_0_0_1:9000 1234.5" in lines
    assert "repro_label_store_hits 7.0" in lines
    assert not any("bad_value" in ln for ln in lines)       # NaN dropped
    assert "_9starts_with_digit 1.0" in [
        ln for ln in lines if "digit" in ln and "TYPE" not in ln
    ][0]
    # every sample line is parseable as "name value"
    for ln in lines:
        if not ln.startswith("#"):
            name, val = ln.split(" ")
            float(val)


def _scrape(pk):
    tracker = pk.obs.InMemoryTracker()
    tracker.count("scrapes", 3)

    def broken():
        raise RuntimeError("wedged store")

    with pk.svc.OracleService(max_wait_ms=WAIT, tracker=tracker) as svc:
        o = pk.core.FnOracle(lambda idx: np.ones(len(idx), np.float64))
        o.bind_sizes((100, 100))
        svc.attach(o)
        _label(pk, o, np.array([[1, 2], [3, 4]]))
        _until(svc, lambda: svc._inflight_rows == 0)
        with pk.obs.MetricsExporter([svc.snapshot, broken], port=0) as exp:
            status, ctype, body = _get(exp.address, "/metrics")
        svc.detach(o)
    body = body.decode("utf-8")
    samples = dict(ln.split(" ") for ln in body.splitlines()
                   if not ln.startswith("#"))
    return status, ctype, body, samples


def test_metrics_exporter_http_roundtrip():
    """The /metrics endpoint serves the merged live snapshots with the
    OpenMetrics content type; a failing source is skipped, not fatal.  The
    reference's exporter serves the same samples."""
    status, ctype, body, samples = _scrape(P)
    assert status == 200
    assert ctype.startswith("application/openmetrics-text")
    assert body.rstrip().endswith("# EOF")
    assert "repro_service_rows_labelled 2.0" in body
    assert "repro_scrapes 3.0" in body
    r_status, r_ctype, _, r_samples = _scrape(R)
    assert (status, ctype) == (r_status, r_ctype)
    _agree(samples, r_samples)


def test_metrics_exporter_404_off_path():
    for pk in (P, R):
        with pk.obs.MetricsExporter([lambda: {"x": 1.0}], port=0) as exp:
            status, _, _ = _get(exp.address, "/nope")
            assert _get(exp.address, "/metrics")[2] == (
                b"# TYPE repro_x gauge\nrepro_x 1.0\n# EOF\n")
        assert status == 404
