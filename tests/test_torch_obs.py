"""The port's observability layer (``repro_torch.obs``: trackers, the
streaming histogram, the typed telemetry tree) against the reference's
(``repro.obs``).  Mirrors the ten cases of ``tests/test_obs.py:39-247`` that
the serving mirrors do not cover: each runs the same inputs through both
packages, asserts the reference's contract on each, and holds the two
results equal."""
import json
import warnings
from types import SimpleNamespace

import pytest

import repro.core as R_core
import repro.core.types as R_types
import repro.obs as R_obs
import repro.obs.telemetry as R_telem
import repro_torch.core as P_core
import repro_torch.core.types as P_types
import repro_torch.obs as P_obs
import repro_torch.obs.telemetry as P_telem

P = SimpleNamespace(obs=P_obs, core=P_core, types=P_types, telem=P_telem)
R = SimpleNamespace(obs=R_obs, core=R_core, types=R_types, telem=R_telem)


def both(fn):
    """fn(package) in both packages; the two results must be equal."""
    mine, theirs = fn(P), fn(R)
    assert mine == theirs
    return mine


# ----------------------------------------------------------------------------
# StreamingHistogram
# ----------------------------------------------------------------------------

def test_histogram_quantiles_track_recent_window_only():
    def case(pkg):
        h = pkg.obs.StreamingHistogram(window=100)
        for v in range(1, 1001):
            h.observe(float(v))
        assert h.count == 1000
        assert h.mean == pytest.approx(500.5)
        assert h.vmin == 1.0 and h.vmax == 1000.0
        assert 901.0 <= h.quantile(0.5) <= 1000.0
        assert h.quantile(0.0) == 901.0 and h.quantile(1.0) == 1000.0
        assert h.recent_mean() == pytest.approx(950.5)
        return (h.count, h.mean, h.vmin, h.vmax, [h.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)],
                h.recent_mean())

    both(case)


def test_histogram_snapshot_names_and_empty():
    def case(pkg):
        h = pkg.obs.StreamingHistogram(window=8)
        assert h.snapshot("x") == {}
        h.observe(2.0)
        h.observe(4.0)
        snap = h.snapshot("service.window.assembly_ms")
        assert set(snap) == {f"service.window.assembly_ms.{s}"
                             for s in ("count", "mean", "p50", "p99", "max")}
        assert snap["service.window.assembly_ms.count"] == 2.0
        assert snap["service.window.assembly_ms.mean"] == 3.0
        assert snap["service.window.assembly_ms.max"] == 4.0
        with pytest.raises(ValueError):
            pkg.obs.StreamingHistogram(window=0)
        return snap

    both(case)


# ----------------------------------------------------------------------------
# trackers
# ----------------------------------------------------------------------------

def test_in_memory_tracker_snapshot_is_flat_dotted_floats():
    def case(pkg):
        t = pkg.obs.InMemoryTracker()
        assert isinstance(t, pkg.obs.Tracker)
        t.count("transport.reconnects")
        t.count("transport.reconnects", 2)
        t.gauge("transport.inflight", 5)
        for ms in (1.0, 2.0, 3.0, 4.0):
            t.observe("transport.rtt_ms", ms)
        t.event("service.worker.dead", worker="h:1")
        snap = t.snapshot()
        assert snap["transport.reconnects"] == 3
        assert snap["transport.inflight"] == 5.0
        assert snap["transport.rtt_ms.count"] == 4.0
        assert snap["transport.rtt_ms.mean"] == 2.5
        assert snap["service.worker.dead.events"] == 1.0
        assert all(isinstance(v, (float, int)) for v in snap.values())
        assert t.histogram("transport.rtt_ms").count == 4
        assert t.histogram("never.observed") is None
        return snap

    both(case)


def test_noop_tracker_is_protocol_and_empty():
    def case(pkg):
        t = pkg.obs.NoopTracker()
        assert isinstance(t, pkg.obs.Tracker)
        t.count("a")
        t.gauge("b", 1.0)
        t.observe("c", 2.0)
        t.event("d", x=1)
        snap = t.snapshot()
        t.close()
        return snap

    assert both(case) == {}


def test_jsonl_tracker_writes_parseable_lines(tmp_path):
    def case(pkg):
        path = tmp_path / f"{pkg.obs.__name__}.jsonl"
        t = pkg.obs.JsonlTracker(path, flush_every=1)
        t.count("service.windows")
        t.observe("service.shard.local_ms", 1.5)
        t.event("service.worker.rejoined", worker="h:2")
        snap = t.snapshot()
        assert snap["service.windows"] == 1
        t.close()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert all("ts" in r for r in lines)
        t.count("after.close")                     # dropped, no raise
        return snap, [{k: v for k, v in r.items() if k != "ts"} for r in lines]

    snap, lines = both(case)
    assert [r["kind"] for r in lines] == ["count", "observe", "event"]
    assert lines[1]["name"] == "service.shard.local_ms" and lines[1]["value"] == 1.5
    assert lines[2]["worker"] == "h:2"


def test_make_tracker_factory(tmp_path):
    def case(pkg):
        obs = pkg.obs
        kinds = [type(obs.make_tracker(k)).__name__ for k in ("none", None, "memory")]
        jt = obs.make_tracker("jsonl", path=tmp_path / f"{obs.__name__}.jsonl")
        kinds.append(type(jt).__name__)
        jt.close()
        for bad in ({"kind": "jsonl"}, {"kind": "statsd"}):
            with pytest.raises(ValueError):
                obs.make_tracker(**bad)
        return kinds

    assert both(case) == ["NoopTracker", "NoopTracker", "InMemoryTracker", "JsonlTracker"]


def test_merge_snapshots_later_parts_win():
    merged = both(lambda pkg: pkg.obs.merge_snapshots({"a": 1.0}, None, {"a": 2.0, "b": 3.0}))
    assert merged == {"a": 2.0, "b": 3.0}


# ----------------------------------------------------------------------------
# QueryTelemetry <-> legacy detail dict
# ----------------------------------------------------------------------------

_LEGACY_DETAIL = {
    "mode": "bas",
    "beta": [0.5, 0.5],
    "num_strata": 4,
    "stratum_sizes": [10, 20, 30, 40],
    "pilot_n": [5, 5, 5, 5],
    "est_mse": 0.002,
    "stratify": {"path": "sweep", "index_hit": True, "index_version": 3,
                 "delta_blocks": 2, "sweep_tiles": 7},
    "timings": {"stratify_s": 0.1, "sample_s": 0.2},
    "oracle": {"calls": 100, "requests": 150, "batches": 4, "charged": 90,
               "store_hits": 10, "store_charge_saved": 10, "dedup_ratio": 0.33},
    "dispatch": {"path": "sweep", "dense_weight_bytes": 1024,
                 "max_dense_weight_bytes": 4096, "n_tuples": 10000, "sweep": True,
                 "sweep_precision": "bf16", "index_store": True},
}


def test_telemetry_round_trips_legacy_detail_exactly():
    def case(pkg):
        t = pkg.obs.QueryTelemetry.from_detail(_LEGACY_DETAIL)
        assert t.mode == "bas" and t.oracle.calls == 100 and t.store.hits == 10
        assert t.index.hit is True and t.index.version == 3 and t.index.build_ms is None
        assert t.stratify.path == "sweep" and t.stratify.extra == {"sweep_tiles": 7}
        assert t.dispatch.sweep_precision == "bf16"
        assert t.as_detail() == _LEGACY_DETAIL
        return t.as_detail()

    both(case)


def test_telemetry_round_trips_sparse_details():
    details = ({}, {"mode": "exact"}, {"mode": "wwj", "weights": [1, 2]},
               {"oracle": {"calls": 1, "requests": 1, "batches": 1, "charged": 1,
                           "dedup_ratio": 0.0}},
               {"stratify": {"path": "dense-sort"}})
    out = both(lambda pkg: [pkg.obs.QueryTelemetry.from_detail(d).as_detail()
                            for d in details])
    assert out == list(details)


def test_query_result_detail_is_deprecated_write_through_view():
    def case(pkg):
        res = pkg.core.QueryResult(1.0, pkg.types.ConfidenceInterval(0.5, 1.5, 0.95), 10,
                                   detail=dict(_LEGACY_DETAIL))
        assert res.telemetry.oracle.requests == 150
        pkg.telem._warned = False                   # re-arm the one-shot warning
        with pytest.warns(DeprecationWarning):
            view = res.detail
        assert view["mode"] == "bas" and view["oracle"]["calls"] == 100
        assert "dispatch" in view and "nonexistent" not in view
        assert dict(view) == _LEGACY_DETAIL
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            res.detail["mode"] = "exact"
            assert res.telemetry.mode == "exact"
            res.detail["custom"] = 42
            assert res.telemetry.extra["custom"] == 42
            del res.detail["stratify"]
            assert res.telemetry.stratify is None and res.telemetry.index is None
            with pytest.raises(KeyError):
                del res.detail["never-there"]
            return dict(res.detail)

    both(case)


def test_query_result_rejects_detail_and_telemetry_together():
    def case(pkg):
        ci = pkg.types.ConfidenceInterval(0.5, 1.5, 0.95)
        t = pkg.obs.QueryTelemetry(mode="bas")
        with pytest.raises(TypeError):
            pkg.core.QueryResult(1.0, ci, 1, detail={"mode": "bas"}, telemetry=t)
        res = pkg.core.QueryResult(1.0, ci, 1, telemetry=t)
        assert res.telemetry is t
        return res.telemetry.as_detail()

    both(case)
