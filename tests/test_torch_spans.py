"""The port's spans and counters (``repro_torch.obs.telemetry``): the stage
spans under ``JoinMLEngine.execute`` with their parents and query ids, the
``timings`` they sum into, the window log that fills only while a
``torch.profiler`` session records (on the profiler's clock), the scorer's
and the MoE's counters, and the service's queue-wait and window spans."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import ArrayOracle, BASConfig, Catalog, JoinMLEngine, Table
from repro_torch.core.oracle import OracleBatch
from repro_torch.data.synthetic import make_clustered_tables
from repro_torch.models import init_params
from repro_torch.models.layers import moe_capacity, moe_mlp, moe_route
from repro_torch.obs import InMemoryTracker, telemetry
from repro_torch.serve import OracleService, PairScorer

SQL = ("SELECT COUNT(*) FROM a JOIN b ON NL('same') "
       "ORACLE BUDGET 1500 WITH PROBABILITY 0.95")
STREAM = dataclasses.replace(BASConfig(), max_dense_weight_bytes=1024)
# path -> (config, method, the stage spans' names)
PATHS = {
    "dense": (BASConfig(), "auto",
              ("similarity", "stratify", "pilot", "allocate", "execute", "ci")),
    "streaming": (STREAM, "auto",
                  ("stratify", "similarity", "walk_setup", "pilot", "allocate",
                   "execute", "ci")),
    "cascade": (STREAM, "bas-cascade",
                ("stratify", "similarity", "walk_setup", "pilot", "allocate",
                 "execute", "ci")),
}
# the timings every path kept from before the spans (``total_s`` went)
KEYS = {"dense": ("similarity_s", "stratify_s", "pilot_s", "allocate_s", "execute_s", "ci_s")}
KEYS["streaming"] = KEYS["cascade"] = KEYS["dense"] + ("walk_setup_s",)


@pytest.fixture(scope="module")
def tables():
    ds = make_clustered_tables(200, 200, d=32, seed=11)
    cat = Catalog()
    e1, e2 = ds.spec().embeddings
    cat.register(Table("a", e1, {}))
    cat.register(Table("b", e2, {}))
    return cat, ds.truth


def _execute(tables, path):
    cat, truth = tables
    cfg, method, _ = PATHS[path]
    eng = JoinMLEngine(cat, lambda nl, names: ArrayOracle(truth), cfg=cfg, device="cpu")
    return eng.execute(SQL, method=method, seed=5)


@pytest.fixture(scope="module")
def results(tables):
    return {path: _execute(tables, path) for path in PATHS}


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_under_the_query(results, path):
    t = results[path].telemetry
    by_id = {s.span_id: s for s in t.spans}
    root = [s for s in t.spans if s.parent_id is None]
    assert [s.name for s in root] == ["joinml.query"]
    assert t.query_id is not None and all(s.query_id == t.query_id for s in t.spans)
    for s in t.spans:
        if s.parent_id is not None:
            parent = by_id[s.parent_id]
            assert parent.start <= s.start <= s.end <= parent.end, (s, parent)
    names = {s.name for s in t.spans}
    assert {f"joinml.{n}" for n in PATHS[path][2]} <= names
    # each stage hangs off the root; the sweep's and the walk's off theirs
    parent = {s.name: by_id[s.parent_id].name for s in t.spans if s.parent_id}
    for stage in ("stratify", "pilot", "execute", "ci"):
        assert parent[f"joinml.{stage}"] == "joinml.query"
    if path != "dense":
        assert parent["joinml.walk_setup"] == "joinml.similarity"
        for inner in ("sweep.upload", "sweep.kernel", "sweep.readback", "collect"):
            assert parent[f"joinml.{inner}"] == "joinml.stratify"


@pytest.mark.parametrize("path", list(PATHS))
def test_timings_are_the_spans_durations(results, path):
    t = results[path].telemetry
    assert "total_s" not in t.timings
    for key in KEYS[path] + ("query_wall_s",):
        spans = [s for s in t.spans if telemetry.timing_key(s.name) == key]
        assert spans and t.timings[key] > 0, key
        assert t.timings[key] == pytest.approx(sum(s.seconds for s in spans), rel=1e-12)
    assert set(t.timings) == {telemetry.timing_key(s.name) for s in t.spans}


@pytest.mark.parametrize("path", ["streaming", "cascade"])
def test_stages_cover_their_inner_spans(results, path):
    tm = results[path].telemetry.timings
    assert tm["stratify_s"] >= (tm["sweep_upload_s"] + tm["sweep_kernel_s"]
                                + tm["sweep_readback_s"] + tm["collect_s"])
    assert tm["similarity_s"] >= tm["walk_setup_s"]
    assert tm["query_wall_s"] >= sum(tm[k] for k in KEYS[path] if k != "walk_setup_s")


def test_recording_reads_the_profilers_process_wide_flag():
    """``recording()`` reads torch's private ``_is_profiler_enabled`` (a
    torch without it would silently leave the log empty): fail loudly if
    it is gone or stops following a session."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not telemetry.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.recording()
        seen = []
        t = threading.Thread(target=lambda: seen.append(telemetry.recording()))
        t.start()
        t.join(timeout=30.0)
        assert seen == [True]                 # on every thread
    assert not telemetry.recording()


def test_no_profiler_no_log_and_no_record_function(tables, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    # the ops behind record_function, which a span calls directly
    monkeypatch.setattr(telemetry, "_annotation_ops", refuse)
    telemetry.clear_window_log()
    res = _execute(tables, "streaming")
    assert res.telemetry.spans
    log = telemetry.window_log()
    assert log.spans == [] and log.counters == {}


def test_logged_spans_lie_on_their_profiler_events(tables):
    telemetry.clear_window_log()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a session's first event opens a few hundred microseconds late
        with torch.profiler.record_function("warm-up"):
            pass
        res = _execute(tables, "streaming")
    log = telemetry.window_log()
    telemetry.clear_window_log()
    assert len(log.spans) == len(res.telemetry.spans)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("joinml."):
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    logged = {}
    for s in log.spans:
        logged.setdefault(s.name, []).append((s.start, s.end))
    assert set(logged) == set(events)
    for name, spans in logged.items():
        assert len(spans) == len(events[name]), name
        for (a, b), (ea, eb) in zip(sorted(spans), sorted(events[name])):
            assert abs(a - ea) <= 500_000 and abs(b - eb) <= 500_000, (name, a - ea, b - eb)


def _scorer(batch=256):
    cfg = get_smoke_config("joinml-oracle", vocab_size=64, dtype="float32")
    params = init_params(cfg, device="cpu")
    # every pair 20 tokens: one bucket (32) at max_len 48
    tokens = (np.arange(20) % 60 + 3).astype(np.int32)
    return PairScorer(cfg, params, lambda pair: tokens, 1, 2, max_len=48,
                      batch_size=batch, device="cpu")


def test_scorer_counts_pairs_rows_and_tokens():
    """The pairs and rows (padding rows included) are the scorer's own
    ``pairs_scored`` and ``forward_batches``; the tokens are counters."""
    scorer = _scorer()
    pairs = np.stack([np.arange(300), np.arange(300)], 1)
    telemetry.clear_window_log()
    with telemetry.query() as q:
        with profile(activities=[ProfilerActivity.CPU]):
            scorer.score(pairs)
    logged = telemetry.window_log().counters
    telemetry.clear_window_log()
    assert scorer.pairs_scored == 300
    assert scorer.forward_batches * scorer.batch_size == 512
    want = {"scorer.tokens_useful": 300 * 20, "scorer.tokens_forwarded": 512 * 32}
    assert q.counters == want
    assert {k: v for k, v in logged.items() if k.startswith("scorer.")} == want
    assert want["scorer.tokens_useful"] <= want["scorer.tokens_forwarded"]
    names = [s.name for s in q.spans]
    assert names.count("joinml.score") == 1
    assert names.count("joinml.score.tokenize") == 3      # tokens, then each batch's padding
    assert names.count("joinml.score.forward") == names.count("joinml.score.readback") == 2
    score = next(s for s in q.spans if s.name == "joinml.score")
    assert all(s.parent_id == score.span_id for s in q.spans if s.name.startswith("joinml.score."))


@pytest.mark.parametrize("batch", [2, 4])
def test_moe_counts_its_capacity_slots(batch):
    cfg = get_smoke_config("olmoe-1b-7b", dtype="float32")
    layer = init_params(cfg, device="cpu").layers[0]
    p = layer.moe
    x = torch.randn(batch, 16, cfg.d_model, generator=torch.Generator().manual_seed(batch))
    telemetry.clear_window_log()
    with profile(activities=[ProfilerActivity.CPU]):
        moe_mlp(p, cfg, x)
    got = telemetry.window_log().counters
    telemetry.clear_window_log()
    t = batch * 16
    keep = moe_route(p, cfg, x.reshape(t, cfg.d_model))[2]
    dropped = int((~keep).sum())
    assert keep.numel() == t * cfg.num_experts_per_tok        # routed
    assert got["moe.kept"] + dropped == keep.numel()
    assert got["moe.slots"] == cfg.num_experts * moe_capacity(cfg, t)
    assert got["moe.kept"] <= got["moe.slots"]


def test_service_queue_wait_and_window_spans():
    truth = np.ones((50, 50))
    tracker = InMemoryTracker()
    svc = OracleService(workers=1, max_wait_ms=60_000.0, tracker=tracker)
    oracles = [ArrayOracle(truth), ArrayOracle(truth)]
    svc.attach(*oracles)
    got, errors = {}, []

    def client(i):
        try:
            with telemetry.query() as q:
                with telemetry.span("joinml.execute"):
                    batch = OracleBatch(oracles[i])
                    batch.submit(np.stack([np.arange(10), np.arange(10) + i], 1))
                    batch.flush_async().result(timeout=30.0)
            got[i] = q
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close()
    assert not errors, errors
    ids = {got[0].id, got[1].id}
    assert len(ids) == 2
    waits = []
    for q in got.values():
        wait = [s for s in q.spans if s.name == "joinml.queue_wait"]
        execute = next(s for s in q.spans if s.name == "joinml.execute")
        assert len(wait) == 1 and wait[0].query_id == q.id
        assert wait[0].parent_id == execute.span_id
        assert q.timings["queue_wait_s"] == pytest.approx(wait[0].seconds, rel=1e-12)
        window = [s for s in q.spans if s.name == "joinml.service.window"]
        assert len(window) == 1 and set(window[0].query_id) == ids
        waits.append(wait[0].seconds * 1e3)
    snap = tracker.snapshot()
    assert snap["service.window.assembly_ms.count"] == 2.0
    assert snap["service.window.assembly_ms.max"] == pytest.approx(max(waits))


def test_spans_and_counts_from_many_threads_lose_nothing():
    """A query's record and the window log are shared by the threads that
    close spans into them (a client and the service's dispatcher)."""
    n_threads, n_each = 16, 300
    telemetry.clear_window_log()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.query() as q, profile(activities=[ProfilerActivity.CPU]):
            def work():
                for _ in range(n_each):
                    t0 = time.perf_counter_ns()
                    telemetry.record("joinml.queue_wait", t0, t0 + 1000, q)
                    q.count("hits", 1)
                    telemetry.log_count("hits", 1)

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    log = telemetry.window_log()
    telemetry.clear_window_log()
    n = n_threads * n_each
    assert q.counters["hits"] == n and log.counters["hits"] == n
    waits = [s for s in q.spans if s.name == "joinml.queue_wait"]
    assert len(waits) == n and len({s.span_id for s in waits}) == n
    assert q.timings["queue_wait_s"] == pytest.approx(n * 1e-6)
    assert sum(s.name == "joinml.queue_wait" for s in log.spans) == n
