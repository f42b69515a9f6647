"""The port's persistent stratification index (``repro_torch.core.index`` +
``repro_torch.checkpoint.index_io``) on the CPU, mirroring
``tests/test_core_index.py``, the two index tests of
``tests/test_chain_stats.py`` and the store snapshot test of
``tests/test_obs.py``, then held against the reference package.

Tolerances, by test:

* **Within the port, exact.**  A hydrated sweep, its strata and a hydrated
  query's estimate and CI equal the fresh ones bit for bit (the artifact is
  the fresh sweep's output); a save -> mmap-load round trip is exact; the
  content key equals the reference's.
* **Appends within the port, exact.**  Count tiles and the valid top-k
  equal a full rebuild bit for bit, on the blocked host path and on the
  kernel path's plain version, for left and right appends, fp32 and int8.
  The right append's delta sweep scores fewer columns than the rebuild, so
  this needs the plain sweep's ``torch.matmul`` to give each score the
  same bits whatever the operand's shape: it does at these widths (d 16
  and 24; every case here, and 48 further random right appends), where
  XLA does not in the reference's own failing ``[1-True]`` case.  Walk
  sums and ``total_weight`` within 1e-6 relative (the fused sums'
  contract, ``tests/test_chain_stats.py``).
* **Across packages.**  Artifacts load both ways and hydrate to exactly
  what they store; counts and top-k of the two packages' builds agree under
  the edge and near-tie rules; estimates hydrated from either side's
  artifact agree with the reference's within 1e-6 relative (the tolerance
  of ``tests/test_torch_bas.py``), with equal Oracle calls.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.index_io import (latest_version, list_indexes,
                                             load_index, save_index)
from repro_torch.core import (
    Agg,
    BASConfig,
    Catalog,
    IndexStore,
    JoinMLEngine,
    Query,
    Table,
    append_rows,
    artifact_key,
    build_index,
    run_auto,
    run_bas_cascade,
    run_bas_streaming,
    table_fingerprint,
)
from repro_torch.core import similarity
from repro_torch.core.index import _regroup_tiles
from repro_torch.core.similarity import normalize
from repro_torch.core.stratify import (stratify_streaming,
                                       stratify_streaming_chain, sweep_pass,
                                       threshold_for_top_m)
from repro_torch.data import make_chain_dataset, make_clustered_tables
from repro_torch.kernels import checks
from repro_torch.obs import InMemoryTracker

CFG = BASConfig()
BINS = 512
DEV = "cpu"
REL = 1e-6  # walk sums, total weight, estimates across packages


def _tables(n1, n2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (
        normalize(rng.standard_normal((n1, d))).astype(np.float32),
        normalize(rng.standard_normal((n2, d))).astype(np.float32),
    )


def _build(embs, **kw):
    kw.setdefault("n_bins", BINS)
    kw.setdefault("exponent", CFG.weight_exponent)
    kw.setdefault("floor", CFG.weight_floor)
    kw.setdefault("device", DEV)
    return build_index(list(embs), **kw)


def _store(**kw):
    return IndexStore(device=DEV, **kw)


def _assert_artifacts_equal(a, b):
    assert a.key == b.key
    assert a.sizes == b.sizes
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))
    np.testing.assert_array_equal(np.asarray(a.edges), np.asarray(b.edges))
    np.testing.assert_array_equal(np.asarray(a.block_counts),
                                  np.asarray(b.block_counts))
    if a.topk_vals is not None or b.topk_vals is not None:
        np.testing.assert_array_equal(np.asarray(a.topk_valid),
                                      np.asarray(b.topk_valid))
        valid = np.asarray(a.topk_valid)
        np.testing.assert_array_equal(np.asarray(a.topk_vals)[valid],
                                      np.asarray(b.topk_vals)[valid])
        np.testing.assert_array_equal(np.asarray(a.topk_idx)[valid],
                                      np.asarray(b.topk_idx)[valid])


def _assert_artifacts_edge_equal(a, b):
    """Key, sizes and mass exactly; count tiles under the edge rule and the
    top-k under the near-tie rule of ``kernels.checks``, over the exact
    scores of ``a``'s tables (which must be ``b``'s)."""
    assert a.key == b.key and a.sizes == b.sizes
    assert a.block_rows == b.block_rows
    assert int(np.asarray(a.counts).sum()) == int(np.asarray(b.counts).sum())
    e1, e2 = (torch.from_numpy(np.array(e)) for e in a.embeddings)
    s64, bound = checks.exact_scores(e1, e2, a.precision)
    checks.check_counts(
        [torch.from_numpy(np.array(a.block_counts)),
         torch.from_numpy(np.array(b.block_counts))],
        s64, bound, n_bins=a.n_bins, exponent=a.exponent, floor=a.floor,
        bm=a.block_rows)
    if a.topk_vals is not None:
        np.testing.assert_array_equal(np.asarray(a.topk_valid),
                                      np.asarray(b.topk_valid))
        checks.check_topk(*(torch.from_numpy(np.array(x)) for x in (
            a.topk_vals, a.topk_idx, b.topk_vals, b.topk_idx)), s64, bound)


# ----------------------------------------------------------------------------
# content key
# ----------------------------------------------------------------------------

def test_key_tracks_sweep_inputs_not_execution_details():
    e1, e2 = _tables(40, 50)
    base = artifact_key([e1, e2], BINS, 1.0, 1e-3, "fp32")
    assert base == artifact_key([e1, e2], BINS, 1.0, 1e-3, "fp32")
    # anything that changes sweep output changes the key
    assert base != artifact_key([e2, e1], BINS, 1.0, 1e-3, "fp32")
    assert base != artifact_key([e1, e2], 2 * BINS, 1.0, 1e-3, "fp32")
    assert base != artifact_key([e1, e2], BINS, 2.0, 1e-3, "fp32")
    assert base != artifact_key([e1, e2], BINS, 1.0, 1e-2, "fp32")
    assert base != artifact_key([e1, e2], BINS, 1.0, 1e-3, "int8")
    bumped = e1.copy()
    bumped[0, 0] += 1e-3
    assert base != artifact_key([normalize(bumped), e2], BINS, 1.0, 1e-3,
                                "fp32")
    # execution details (block size, kernel on/off) are NOT key components
    assert (_build([e1, e2], block=32, use_kernel=False).key
            == _build([e1, e2], block=4096, use_kernel=True).key == base)


def test_artifact_check_rejects_mismatched_query():
    e1, e2 = _tables(40, 50)
    art = _build([e1, e2])
    art.check(sizes=(40, 50), n_bins=BINS, exponent=CFG.weight_exponent,
              floor=CFG.weight_floor)
    with pytest.raises(ValueError, match="n_bins"):
        art.check(n_bins=BINS * 2)
    with pytest.raises(ValueError, match="covers tables"):
        art.check(sizes=(41, 50))
    with pytest.raises(ValueError):
        sweep_pass(e1, e2, n_bins=BINS * 2, artifact=art, device=DEV)


# ----------------------------------------------------------------------------
# hydration bit-identity (fp32)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_hydrated_sweep_is_bit_identical(use_kernel):
    e1, e2 = _tables(150, 130, seed=3)
    art = _build([e1, e2], use_kernel=use_kernel)
    fresh = sweep_pass(e1, e2, n_bins=BINS, exponent=CFG.weight_exponent,
                       floor=CFG.weight_floor, use_kernel=use_kernel,
                       device=DEV)
    hyd = sweep_pass(e1, e2, n_bins=BINS, exponent=CFG.weight_exponent,
                     floor=CFG.weight_floor, artifact=art, device=DEV)
    np.testing.assert_array_equal(np.asarray(hyd.counts),
                                  np.asarray(fresh.counts))
    np.testing.assert_array_equal(np.asarray(hyd.edges),
                                  np.asarray(fresh.edges))
    np.testing.assert_array_equal(np.asarray(hyd.block_counts),
                                  np.asarray(fresh.block_counts))
    np.testing.assert_array_equal(hyd.row_sums[0], fresh.row_sums[0])
    assert hyd.total_weight == fresh.total_weight
    assert hyd.stats["index_version"] == 1


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hydrated_stratification_matches_fresh(use_kernel):
    e1, e2 = _tables(150, 130, seed=3)
    art = _build([e1, e2], use_kernel=use_kernel)
    budget = 600
    fresh = stratify_streaming(e1, e2, CFG.alpha, budget, CFG, n_bins=BINS,
                               use_kernel=use_kernel, device=DEV)
    hyd = stratify_streaming(e1, e2, CFG.alpha, budget, CFG, n_bins=BINS,
                             artifact=art, device=DEV)
    np.testing.assert_array_equal(fresh.order, hyd.order)
    np.testing.assert_array_equal(fresh.bounds, hyd.bounds)
    np.testing.assert_array_equal(fresh.order_weights, hyd.order_weights)


def test_hydrated_chain_stratification_matches_fresh():
    """A 3-way chain artifact (prefix tiles, the fused walk sums of every
    edge) hydrates to the fresh chain strata and statistics exactly."""
    ch = make_chain_dataset([6, 10, 40], d=16, seed=1)
    embs = [np.asarray(e, np.float32) for e in ch.spec().embeddings]
    art = _build(embs, block=16)
    fresh = stratify_streaming_chain(embs, CFG.alpha, 800, CFG, n_bins=BINS,
                                     use_kernel=True, device=DEV)
    hyd = stratify_streaming_chain(embs, CFG.alpha, 800, CFG, n_bins=BINS,
                                   artifact=art, device=DEV)
    np.testing.assert_array_equal(fresh.order, hyd.order)
    np.testing.assert_array_equal(fresh.bounds, hyd.bounds)
    for a, b in zip(fresh.sweep.row_sums, hyd.sweep.row_sums):
        np.testing.assert_array_equal(a, b)
    assert fresh.sweep.total_weight == hyd.sweep.total_weight


def test_streaming_estimates_bit_identical_with_index(tmp_path):
    """Fresh sweep, resident artifact, store-resolved artifact, and a
    save -> mmap-load round trip must all land the SAME estimate and CI."""
    ds = make_clustered_tables(130, 130, n_entities=160, noise=0.4, seed=5)

    def q():
        return Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(),
                     budget=1500)

    base = run_bas_streaming(q(), CFG, seed=0, n_bins=BINS, device=DEV)
    embs = [np.asarray(e, np.float32) for e in ds.spec().embeddings]
    art = _build(embs, use_kernel=CFG.use_kernel)
    hyd = run_bas_streaming(q(), CFG, seed=0, n_bins=BINS, artifact=art,
                            device=DEV)
    store = _store()
    cold = run_bas_streaming(q(), CFG, seed=0, n_bins=BINS,
                             index_store=store, device=DEV)
    warm = run_bas_streaming(q(), CFG, seed=0, n_bins=BINS,
                             index_store=store, device=DEV)

    save_index(str(tmp_path), art)
    loaded = load_index(str(tmp_path), art.key)
    disk = run_bas_streaming(q(), CFG, seed=0, n_bins=BINS, artifact=loaded,
                             device=DEV)

    for res in (hyd, cold, warm, disk):
        assert res.estimate == base.estimate
        assert res.ci.lo == base.ci.lo and res.ci.hi == base.ci.hi
    # observability: the stratify telemetry says how the sweep was obtained
    assert base.telemetry.index is None
    assert hyd.telemetry.stratify.path == "index"
    assert hyd.telemetry.index.hit is True
    assert cold.telemetry.index.hit is False
    assert cold.telemetry.index.build_ms >= 0
    assert warm.telemetry.index.hit is True
    assert disk.telemetry.index.version == 1
    assert disk.telemetry.index.delta_blocks == 0


def test_run_auto_routes_through_resident_index():
    """Dense-footprint queries route dense on an empty store, but a fresh
    resident artifact overrides the memory model (``streaming-index``) and
    reproduces the plain streaming estimate bit-for-bit."""
    ds = make_clustered_tables(120, 120, n_entities=150, noise=0.4, seed=7)

    def q():
        return Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(),
                     budget=1200)

    store = _store()
    res = run_auto(q(), CFG, seed=0, n_bins=BINS, index_store=store,
                   device=DEV)
    assert res.telemetry.dispatch.path == "dense"   # miss stays dense
    assert res.telemetry.dispatch.index_store is True
    assert store.stats()["index_build"] == 0

    embs = [np.asarray(e, np.float32) for e in ds.spec().embeddings]
    store.add(_build(embs, use_kernel=CFG.use_kernel))
    routed = run_auto(q(), CFG, seed=0, n_bins=BINS, index_store=store,
                      device=DEV)
    assert routed.telemetry.dispatch.path == "streaming-index"
    plain = run_bas_streaming(q(), CFG, seed=0, n_bins=BINS, device=DEV)
    assert routed.estimate == plain.estimate

    # streaming-routed miss builds through the store -> next query hits
    cfg_small = dataclasses.replace(CFG, max_dense_weight_bytes=1024)
    store2 = _store()
    first = run_auto(q(), cfg_small, seed=0, n_bins=BINS, index_store=store2,
                     device=DEV)
    assert first.telemetry.dispatch.path == "streaming"
    assert store2.stats()["index_build"] == 1
    second = run_auto(q(), cfg_small, seed=0, n_bins=BINS,
                      index_store=store2, device=DEV)
    assert second.telemetry.dispatch.path == "streaming-index"
    assert first.estimate == second.estimate


def test_engine_and_cascade_stratify_from_the_store():
    """``JoinMLEngine(index_store=...)``: ``auto`` routes a warm query
    through the index, the streaming and cascade methods resolve through
    the store, and ``run_auto`` with ``cfg.cascade`` takes
    ``cascade-streaming-index``; each equals its fresh run bit for bit."""
    ds = make_clustered_tables(120, 110, n_entities=60, noise=0.4, seed=3)
    cat = Catalog()
    cat.register(Table("a", ds.emb1, ds.columns1))
    cat.register(Table("b", ds.emb2, ds.columns2))
    cfg = BASConfig(max_dense_weight_bytes=0, n_bootstrap=100)
    orc = lambda nl, names: ds.oracle()  # noqa: E731
    sql = "SELECT SUM(a.value) FROM a JOIN b ON NL('x') ORACLE BUDGET 600"
    fresh = JoinMLEngine(cat, orc, cfg=cfg, device=DEV)
    store = _store()
    eng = JoinMLEngine(cat, orc, cfg=cfg, index_store=store, device=DEV)
    cold = eng.execute(sql)
    warm = eng.execute(sql)
    assert cold.telemetry.dispatch.path == "streaming"
    assert warm.telemetry.dispatch.path == "streaming-index"
    assert store.stats()["index_build"] == 1
    want = fresh.execute(sql)
    for res in (cold, warm):
        assert (res.estimate, res.ci.lo, res.ci.hi) == (
            want.estimate, want.ci.lo, want.ci.hi)
    for method in ("bas-streaming", "bas-cascade"):
        got, ref = eng.execute(sql, method=method), fresh.execute(sql, method=method)
        assert got.telemetry.index.hit is True
        assert (got.estimate, got.ci.lo, got.ci.hi) == (
            ref.estimate, ref.ci.lo, ref.ci.hi)
    q = eng.build(sql)
    art = store.lookup([ds.emb1, ds.emb2], n_bins=4096)
    casc = run_bas_cascade(q, cfg, seed=0, artifact=art, device=DEV)
    assert casc.telemetry.stratify.path == "index"
    auto = run_auto(eng.build(sql), dataclasses.replace(cfg, cascade=True),
                    seed=0, index_store=store, device=DEV)
    assert auto.telemetry.dispatch.path == "cascade-streaming-index"
    assert auto.estimate == casc.estimate


# ----------------------------------------------------------------------------
# delta maintenance == full recompute (property, random splits)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("table", [0, 1])
def test_append_equals_full_recompute_random_splits(use_kernel, table):
    """Property: for random table sizes and split points, building an index
    on a prefix and appending the remainder is a build on the full tables —
    tiles, top-k, and content key.  ``block=32`` forces multiple row tiles
    so boundary-straddling appends are exercised.  Exact in every case,
    the reference's failing ``[1-True]`` too (see the module docstring)."""
    rng = np.random.default_rng(42 + table + 2 * use_kernel)
    for trial in range(4):
        n1, n2 = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        delta = int(rng.integers(1, 40))
        full = _tables(n1 + (delta if table == 0 else 0),
                       n2 + (delta if table == 1 else 0),
                       seed=int(rng.integers(1 << 30)))
        prefix = [full[0][:n1], full[1][:n2]]
        art = _build(prefix, block=32, use_kernel=use_kernel)
        grown = append_rows(art, table, full[table][-delta:],
                            use_kernel=use_kernel, device=DEV)
        ref = _build(list(full), block=32, use_kernel=use_kernel)
        _assert_artifacts_equal(grown, ref)
        np.testing.assert_allclose(grown.row_sums[0], ref.row_sums[0],
                                   rtol=REL)
        assert grown.total_weight == pytest.approx(ref.total_weight, rel=REL)
        assert grown.version == 2 and grown.stats["appends"] == 1
        assert grown.stats["delta_rows"] == delta


def test_append_equals_full_recompute_int8():
    """The low-precision (int8) tiles obey the same exactness: the delta
    sweep quantises identically and int8 scores are exact integer sums
    scaled in a fixed order, so appended tiles equal a full int8 recompute
    bit for bit.  ``tolerance=inf`` pins the effective precision to int8 on
    both sides (no fp32 fallback)."""
    rng = np.random.default_rng(11)
    for trial in range(2):
        n1, n2 = int(rng.integers(48, 100)), int(rng.integers(48, 100))
        delta = int(rng.integers(4, 32))
        full = _tables(n1, n2 + delta, seed=int(rng.integers(1 << 30)))
        prefix = [full[0], full[1][:n2]]
        art = _build(prefix, block=32, use_kernel=True, precision="int8",
                     tolerance=float("inf"))
        assert art.precision == "int8"
        grown = append_rows(art, 1, full[1][-delta:], use_kernel=True,
                            device=DEV)
        ref = _build(list(full), block=32, use_kernel=True, precision="int8",
                     tolerance=float("inf"))
        _assert_artifacts_equal(grown, ref)


def test_append_lowp_without_kernel_refuses():
    """A lowp artifact whose delta could only run the fp32 blocked host path
    must refuse rather than silently mix precisions across tiles."""
    e1, e2 = _tables(64, 64)
    art = _build([e1, e2], use_kernel=True, precision="int8",
                 tolerance=float("inf"))
    with pytest.raises(RuntimeError, match="without the sweep kernel"), \
            pytest.warns(UserWarning, match="blocked host path"):
        append_rows(art, 1, _tables(8, 8, seed=9)[1], use_kernel=False,
                    device=DEV)


def test_append_chain_artifact_not_supported():
    e1, e2 = _tables(32, 32)
    e3 = _tables(32, 32, seed=2)[0]
    art = _build([e1, e2, e3], use_kernel=False)
    with pytest.raises(NotImplementedError):
        append_rows(art, 1, e3[:4], device=DEV)


def test_append_at_small_block_rows_nests_into_a_rebuild():
    """An artifact built while the left table had 32 rows keeps 32-row
    tiles: a left append sweeps 32-row chunks, and a right append then
    sweeps every left row at that stride (count tiles of fewer rows than a
    CTA's on the card).  Regrouped to the rebuild's 256-row tiles they equal
    it exactly; the top-k too."""
    e1, e2 = _tables(300, 150, seed=8)
    art = _build([e1[:32], e2[:100]])
    assert art.block_rows == 32
    grown = append_rows(art, 0, e1[32:], device=DEV)
    grown = append_rows(grown, 1, e2[100:], device=DEV)
    ref = _build([e1, e2])
    assert (grown.key, grown.sizes, grown.block_rows) == (ref.key, ref.sizes, 32)
    np.testing.assert_array_equal(
        _regroup_tiles(grown.block_counts, 32, ref.block_rows),
        ref.block_counts)
    _assert_artifacts_equal(
        dataclasses.replace(grown, block_counts=ref.block_counts), ref)
    np.testing.assert_allclose(grown.row_sums[0], ref.row_sums[0], rtol=REL)


def test_stale_artifact_no_longer_matches_after_append():
    """Freshness is structural: once the live tables grow, the old
    artifact's key stops matching, so lookups miss instead of serving a
    stale sweep."""
    e1, e2 = _tables(60, 60)
    store = _store()
    art, hit = store.get_or_build([e1, e2], n_bins=BINS)
    assert not hit
    extra = _tables(8, 8, seed=3)[1]
    grown_tables = [e1, np.concatenate([e2, extra])]
    assert store.lookup(grown_tables, n_bins=BINS) is None
    grown = append_rows(art, 1, extra, use_kernel=CFG.use_kernel, device=DEV)
    store.add(grown)
    found = store.lookup(grown_tables, n_bins=BINS)
    assert found is not None and found.version == 2
    assert store.stats()["delta_blocks"] == grown.stats["last_delta_blocks"]


def test_append_to_mmap_loaded_artifact_raises_no_warning(tmp_path):
    """A loaded artifact's embeddings are read-only memmaps; the port copies
    them once where it takes the rows in, so torch never sees a
    non-writable array (it would warn), and the input files are untouched."""
    e1, e2 = _tables(70, 60, seed=6)
    art = _build([e1, e2])
    save_index(str(tmp_path), art)
    loaded = load_index(str(tmp_path), art.key, mmap=True)
    assert isinstance(loaded.embeddings[0], np.memmap)
    assert not loaded.embeddings[0].flags.writeable
    extra = _tables(9, 9, seed=7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        grown = append_rows(loaded, 0, extra[0], device=DEV)
        grown = append_rows(grown, 1, extra[1], device=DEV)
        sweep_pass(loaded.embeddings[0], loaded.embeddings[1], n_bins=BINS,
                   use_kernel=True, device=DEV)
    _assert_artifacts_equal(
        grown, _build([np.concatenate([e1, extra[0]]),
                       np.concatenate([e2, extra[1]])]))
    np.testing.assert_array_equal(load_index(str(tmp_path), art.key).embeddings[0], e1)


# ----------------------------------------------------------------------------
# IndexStore behaviour
# ----------------------------------------------------------------------------

def test_store_shares_one_build_and_counts():
    e1, e2 = _tables(60, 60)
    store = _store()
    a1, hit1 = store.get_or_build([e1, e2], n_bins=BINS)
    a2, hit2 = store.get_or_build([e1, e2], n_bins=BINS)
    assert (hit1, hit2) == (False, True) and a1 is a2
    s = store.stats()
    assert s["index_build"] == 1 and s["index_hit"] == 1
    assert s["index_miss"] == 1 and s["index_bytes"] == a1.nbytes
    # lookup never builds and never counts a miss
    other = _tables(30, 30, seed=9)
    assert store.lookup(list(other), n_bins=BINS) is None
    assert store.stats()["index_miss"] == 1


def _race(n, target):
    """Run ``target`` on ``n`` threads released together, with a short
    switch interval; every thread must finish within 60 s."""
    start = threading.Barrier(n)
    errors = []

    def run():
        try:
            start.wait()
            target()
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors


def test_store_shares_one_build_across_threads():
    """Concurrent first queries on one key share one build: one thread
    builds on its own thread, the others wait on its future."""
    e1, e2 = _tables(80, 70, seed=4)
    store = _store()
    out = []
    n = 2 * (os.cpu_count() or 4)
    _race(n, lambda: out.append(store.get_or_build([e1, e2], n_bins=BINS)))
    assert sorted(hit for _, hit in out) == [False] + [True] * (n - 1)
    assert len({id(a) for a, _ in out}) == 1
    s = store.stats()
    assert (s["index_build"], s["index_miss"], s["index_hit"]) == (1, 1, n - 1)


def test_store_evicts_lru_under_memory_budget():
    e1, e2 = _tables(60, 60, seed=0)
    probe = build_index([e1, e2], n_bins=BINS, device=DEV)
    tracker = InMemoryTracker()
    store = _store(max_bytes=int(probe.nbytes * 1.5), tracker=tracker)
    store.get_or_build([e1, e2], n_bins=BINS)
    f1, f2 = _tables(60, 60, seed=1)
    store.get_or_build([f1, f2], n_bins=BINS)      # evicts the first
    assert store.stats()["index_evict"] == 1
    assert tracker.snapshot()["index_store.evictions"] == 1.0
    assert store.lookup([e1, e2], n_bins=BINS) is None
    assert store.lookup([f1, f2], n_bins=BINS) is not None
    assert store.bytes_resident <= store.max_bytes


def test_store_loads_from_disk_root(tmp_path):
    e1, e2 = _tables(60, 60)
    art = _build([e1, e2], use_kernel=CFG.use_kernel)
    save_index(str(tmp_path), art)
    store = _store(root=str(tmp_path))
    got, hit = store.get_or_build([e1, e2], n_bins=BINS,
                                  exponent=CFG.weight_exponent,
                                  floor=CFG.weight_floor)
    assert not hit and got.key == art.key
    s = store.stats()
    assert s["index_load"] == 1 and s["index_build"] == 0
    np.testing.assert_array_equal(np.asarray(got.counts), art.counts)


def test_oracle_service_stats_carry_index_counters():
    """An ``OracleService`` given an ``index_store`` merges the store's
    counters into its ``stats()``; without one it carries no index keys."""
    from repro_torch.serve.oracle_service import OracleService

    e1, e2 = _tables(50, 50)
    store = _store()
    with OracleService(workers=1, index_store=store) as svc:
        base = svc.stats()
        assert base["index_hit"] == 0 and base["index_miss"] == 0
        store.get_or_build([e1, e2], n_bins=BINS)
        store.get_or_build([e1, e2], n_bins=BINS)
        s = svc.stats()
    assert s["index_hit"] == 1 and s["index_build"] == 1
    assert s["index_bytes"] > 0
    with OracleService(workers=1) as svc:   # no store -> no index keys
        assert "index_hit" not in svc.stats()


def test_store_snapshot_uses_dotted_namespace(tmp_path):
    """The ``IndexStore`` half of ``tests/test_obs.py``'s snapshot test."""
    snap = _store(root=str(tmp_path)).snapshot()
    assert "index_store.warm_hits" in snap
    assert all(k.startswith("index_store.") for k in snap)
    assert all(isinstance(v, float) for v in snap.values())


# ----------------------------------------------------------------------------
# on-disk IO: roundtrip, versioning, corruption
# ----------------------------------------------------------------------------

def test_index_io_roundtrip_and_versions(tmp_path):
    root = str(tmp_path)
    e1, e2 = _tables(70, 60)
    art = _build([e1, e2], use_kernel=CFG.use_kernel)
    save_index(root, art)
    got = load_index(root, art.key)
    _assert_artifacts_equal(got, art)
    for s in ("version", "n_bins", "exponent", "floor", "precision",
              "precision_requested", "kernel", "block_rows"):
        assert getattr(got, s) == getattr(art, s), s
    assert isinstance(got.counts, np.memmap)   # zero-copy read

    # append -> v2 next to v1; loader picks newest, explicit version works
    extra = _tables(8, 8, seed=4)[1]
    v2 = append_rows(art, 1, extra, use_kernel=CFG.use_kernel, device=DEV)
    save_index(root, v2)
    assert latest_version(root, art.key) == 1   # old lineage untouched
    assert latest_version(root, v2.key) == 2    # version follows the lineage
    listed = list_indexes(root)
    assert sorted(x["key"] for x in listed) == sorted({art.key, v2.key})
    assert load_index(root, v2.key).sizes == (70, 68)

    # same-key versions prune beyond keep_last
    same = load_index(root, art.key, mmap=False)
    for v in (2, 3, 4):
        same = dataclasses.replace(same, version=v)
        save_index(root, same, keep_last=2)
    assert latest_version(root, art.key) == 4
    with pytest.raises(FileNotFoundError):
        load_index(root, art.key, version=1)    # pruned
    assert load_index(root, art.key, version=3).version == 3


def test_index_io_corruption_fails_loudly(tmp_path):
    root = str(tmp_path)
    e1, e2 = _tables(50, 50)
    art = _build([e1, e2], use_kernel=CFG.use_kernel)
    d = save_index(root, art)

    with pytest.raises(FileNotFoundError):
        load_index(root, "deadbeef" * 8)

    # manifest/file shape mismatch (backup kept outside the store tree)
    bak = os.path.join(str(tmp_path), "bak")
    shutil.copytree(d, bak)
    np.save(os.path.join(d, "counts.npy"), np.zeros(10))
    with pytest.raises(ValueError, match="counts"):
        load_index(root, art.key)
    shutil.rmtree(d)
    shutil.copytree(bak, d)

    # missing array
    os.remove(os.path.join(d, "edges.npy"))
    with pytest.raises(ValueError, match="edges"):
        load_index(root, art.key)
    shutil.rmtree(d)
    shutil.copytree(bak, d)

    # artifact misfiled under another key's directory
    wrong = os.path.join(root, "0" * 64)
    shutil.copytree(os.path.join(root, art.key), wrong)
    with pytest.raises(ValueError, match="does not match"):
        load_index(root, "0" * 64)

    # format bump
    meta_path = os.path.join(d, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["format"] = 999
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format"):
        load_index(root, art.key)

    # a torn write (.tmp_ dir) is never visible
    shutil.rmtree(d)
    shutil.copytree(bak, d)
    os.makedirs(os.path.join(root, art.key, ".tmp_00000002"))
    assert load_index(root, art.key).version == 1


# ----------------------------------------------------------------------------
# the fused walk statistics through the index (tests/test_chain_stats.py)
# ----------------------------------------------------------------------------

def _small_query(budget=900):
    ds = make_clustered_tables(150, 150, n_entities=80, noise=0.4, seed=5)
    return Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(),
                 budget=budget)


def _pass_delta(fn):
    before = dict(similarity.PASS_COUNTS)
    result = fn()
    return result, {k: similarity.PASS_COUNTS[k] - before[k]
                    for k in before}


def test_warm_index_query_launches_zero_standalone_passes(tmp_path):
    store = _store(root=tmp_path)
    # cold build populates the store (and computes sums inside the sweep)
    r_cold, delta_cold = _pass_delta(
        lambda: run_bas_streaming(_small_query(), seed=0, index_store=store,
                                  device=DEV)
    )
    assert delta_cold == {"edge_row_sums": 0, "chain_total_weight": 0}
    # warm hit: statistics hydrate from the artifact — no sweep, no passes
    r_warm, delta_warm = _pass_delta(
        lambda: run_bas_streaming(_small_query(), seed=0, index_store=store,
                                  device=DEV)
    )
    assert delta_warm == {"edge_row_sums": 0, "chain_total_weight": 0}
    assert r_warm.telemetry.index.hit is True
    assert r_warm.telemetry.stratify.extra["walk_setup"] == "fused"
    assert r_warm.estimate == r_cold.estimate


def test_index_persists_and_appends_fused_sums(tmp_path):
    rng = np.random.default_rng(3)

    def unit(n, d):
        e = rng.standard_normal((n, d)).astype(np.float32)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    e1, e2 = unit(60, 24), unit(75, 24)
    art = build_index([e1, e2], n_bins=64, exponent=1.5, floor=1e-2,
                      block=64, device=DEV)
    assert art.row_sums is not None and art.total_weight is not None

    # save/load round-trip is exact
    save_index(tmp_path / "idx", art)
    back = load_index(tmp_path / "idx", art.key)
    np.testing.assert_array_equal(back.row_sums[0], art.row_sums[0])
    assert back.total_weight == art.total_weight

    # O(delta) append maintenance matches a fresh cold build to 1e-6
    d1, d2 = unit(17, 24), unit(11, 24)
    grown = append_rows(art, 0, d1, device=DEV)
    grown = append_rows(grown, 1, d2, device=DEV)
    fresh = build_index([np.vstack([e1, d1]), np.vstack([e2, d2])],
                        n_bins=64, exponent=1.5, floor=1e-2, block=64,
                        device=DEV)
    np.testing.assert_allclose(grown.row_sums[0], fresh.row_sums[0],
                               rtol=REL)
    assert grown.total_weight == pytest.approx(fresh.total_weight, rel=REL)


# ----------------------------------------------------------------------------
# the launcher's index modes
# ----------------------------------------------------------------------------

def test_launcher_builds_and_refreshes_an_index(tmp_path, capsys):
    from repro_torch.launch import serve

    root = str(tmp_path / "idx")
    serve.main(["--mode", "build-index", "--index-root", root, "--n-side", "64",
                "--device", "cpu"])
    (first,) = list_indexes(root)
    assert first["sizes"] == (64, 64) and first["version"] == 1
    serve.main(["--mode", "refresh-index", "--index-root", root,
                "--append-rows", "16", "--device", "cpu"])
    newest = max(list_indexes(root), key=lambda s: s["version"])
    assert newest["sizes"] == (64, 80) and newest["version"] == 2
    art = load_index(root, newest["key"])
    assert art.key == artifact_key(art.embeddings, art.n_bins, art.exponent,
                                   art.floor, art.precision_requested)
    _assert_artifacts_equal(art, _build(art.embeddings, n_bins=4096))
    out = capsys.readouterr().out
    assert "[index] built" in out and "[index] refreshed" in out


# ----------------------------------------------------------------------------
# against the reference package
# ----------------------------------------------------------------------------

def test_key_and_fingerprint_equal_the_reference():
    import repro.core.index as R

    e1, e2 = _tables(40, 50, seed=12)
    for emb in (e1, e2, e1.astype(np.float64)):
        assert table_fingerprint(emb) == R.table_fingerprint(emb)
    for prec in ("fp32", "bf16", "int8"):
        assert (artifact_key([e1, e2], BINS, 1.5, 1e-2, prec)
                == R.artifact_key([e1, e2], BINS, 1.5, 1e-2, prec))
    assert (_build([e1, e2]).key
            == R.build_index([e1, e2], n_bins=BINS, use_kernel=False).key)


def _hydrates_to_what_it_stores(art, loaded, budget=600):
    """``loaded`` hydrates to ``art``'s counts, tiles, top-k and threshold
    bin (for the top-m of a query at ``budget``), exactly."""
    info = loaded.sweep_info()
    np.testing.assert_array_equal(np.asarray(info.counts), np.asarray(art.counts))
    np.testing.assert_array_equal(np.asarray(info.block_counts),
                                  np.asarray(art.block_counts))
    for mine, theirs in zip(info.topk, (art.topk_vals, art.topk_idx,
                                        art.topk_valid)):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    m = int(round(CFG.alpha * budget))
    bins = [info.threshold_bin(threshold_for_top_m(np.asarray(a.counts),
                                                   np.asarray(a.edges), m))
            for a in (info, art)]
    assert bins[0] == bins[1]
    assert info.block_rows == art.block_rows and loaded.key == art.key


def test_reference_artifact_loads_in_port(tmp_path):
    """An artifact the reference builds (its Pallas kernel in interpret
    mode, as its own tests run it) and saves loads in the port and hydrates
    to what it stores; the port's own build agrees with it under the edge
    and near-tie rules."""
    import repro.checkpoint.index_io as RIO
    import repro.core.index as R

    e1, e2 = _tables(90, 70, seed=13)
    ref = R.build_index([e1, e2], n_bins=BINS, use_kernel=True)
    RIO.save_index(str(tmp_path), ref)
    loaded = load_index(str(tmp_path), ref.key)
    _hydrates_to_what_it_stores(ref, loaded)
    np.testing.assert_array_equal(loaded.row_sums[0], ref.row_sums[0])
    assert loaded.total_weight == ref.total_weight
    mine = _build([e1, e2])
    _assert_artifacts_edge_equal(mine, loaded)
    np.testing.assert_allclose(mine.row_sums[0], ref.row_sums[0], rtol=REL)


def test_port_artifact_loads_in_reference(tmp_path):
    import repro.checkpoint.index_io as RIO

    e1, e2 = _tables(90, 70, seed=14)
    mine = _build([e1, e2])
    grown = append_rows(mine, 1, _tables(5, 5, seed=2)[1], device=DEV)
    for art in (mine, grown):
        save_index(str(tmp_path), art)
        theirs = RIO.load_index(str(tmp_path), art.key)
        _hydrates_to_what_it_stores(art, theirs)
        assert theirs.version == art.version and theirs.sizes == art.sizes
        np.testing.assert_array_equal(theirs.row_sums[0], art.row_sums[0])
    assert {x["key"] for x in RIO.list_indexes(str(tmp_path))} == {
        x["key"] for x in list_indexes(str(tmp_path))}


def test_estimates_from_either_sides_artifact_match_reference(tmp_path):
    """A streaming query hydrated in the port from the port's artifact and
    from the reference's (through the disk), and one hydrated in the
    reference from the port's, agree with the reference's own hydrated
    query within 1e-6 relative, with equal Oracle calls."""
    import repro.checkpoint.index_io as RIO
    import repro.core as R
    import repro.data as RD

    kw = dict(n1=130, n2=130, n_entities=160, noise=0.4, seed=5)
    rds, pds = RD.make_clustered_tables(**kw), make_clustered_tables(**kw)
    rcfg = R.BASConfig()

    def rq():
        return R.Query(spec=rds.spec(), agg=R.Agg.COUNT, oracle=rds.oracle(),
                       budget=1500)

    def pq():
        return Query(spec=pds.spec(), agg=Agg.COUNT, oracle=pds.oracle(),
                     budget=1500)

    embs = [np.asarray(e, np.float32) for e in pds.spec().embeddings]
    ref_art = R.build_index(embs, n_bins=BINS, use_kernel=True)
    RIO.save_index(str(tmp_path / "ref"), ref_art)
    my_art = _build(embs)
    save_index(str(tmp_path / "port"), my_art)
    want = R.run_bas_streaming(rq(), rcfg, seed=0, n_bins=BINS,
                               artifact=ref_art)
    got = [
        run_bas_streaming(pq(), CFG, seed=0, n_bins=BINS, device=DEV,
                          artifact=load_index(str(tmp_path / "ref"), ref_art.key)),
        run_bas_streaming(pq(), CFG, seed=0, n_bins=BINS, device=DEV,
                          artifact=load_index(str(tmp_path / "port"), my_art.key)),
        R.run_bas_streaming(rq(), rcfg, seed=0, n_bins=BINS,
                            artifact=RIO.load_index(str(tmp_path / "port"),
                                                    my_art.key)),
    ]
    for res in got:
        assert res.estimate == pytest.approx(want.estimate, rel=REL)
        assert res.ci.lo == pytest.approx(want.ci.lo, rel=REL, abs=1e-9)
        assert res.ci.hi == pytest.approx(want.ci.hi, rel=REL, abs=1e-9)
        assert res.oracle_calls == want.oracle_calls


@pytest.mark.parametrize("table", [0, 1])
def test_port_append_to_reference_artifact_matches_reference_append(tmp_path, table):
    """The port appends to an artifact the reference wrote; the result
    equals the reference's own append under the edge and near-tie rules
    (the two packages' matmuls round differently), key and sizes exactly,
    walk sums within 1e-6."""
    import repro.checkpoint.index_io as RIO
    import repro.core.index as R

    e1, e2 = _tables(100, 80, seed=15 + table)
    extra = _tables(23, 23, seed=30 + table)[table]
    ref = R.build_index([e1, e2], n_bins=BINS, block=32, use_kernel=True)
    RIO.save_index(str(tmp_path), ref)
    loaded = load_index(str(tmp_path), ref.key)
    mine = append_rows(loaded, table, extra, device=DEV)
    theirs = R.append_rows(ref, table, extra, use_kernel=True)
    assert mine.version == theirs.version == 2
    _assert_artifacts_edge_equal(mine, theirs)
    np.testing.assert_allclose(mine.row_sums[0], theirs.row_sums[0], rtol=REL)
    assert mine.total_weight == pytest.approx(theirs.total_weight, rel=REL)


# ----------------------------------------------------------------------------
# the device rule
# ----------------------------------------------------------------------------

def test_index_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    ds = make_clustered_tables(40, 30, seed=0)
    e1, e2 = ds.emb1, ds.emb2
    art = _build([e1, e2], n_bins=4096)
    store = _store()
    store.add(art)

    def q():
        return Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(),
                     budget=200)

    for call in (lambda: build_index([e1, e2]),
                 lambda: append_rows(art, 1, e2[:3]),
                 lambda: IndexStore(),
                 lambda: JoinMLEngine(Catalog(), lambda nl, names: None,
                                      index_store=store),
                 lambda: run_auto(q(), index_store=store),
                 lambda: run_bas_streaming(q(), artifact=art),
                 lambda: run_bas_streaming(q(), index_store=store),
                 lambda: run_bas_cascade(q(), artifact=art),
                 lambda: stratify_streaming(e1, e2, 0.2, 200, CFG,
                                            artifact=art)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "build-index", "--index-root", "unused", "--n-side", "16"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(os.path.dirname(__file__)), "src")})
    assert out.returncode != 0 and "CUDA card" in out.stderr
