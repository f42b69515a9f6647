"""The port's multi-fidelity cascade (``repro_torch.core.cascade``) against
the reference's, seeded, on the same numpy inputs.  Mirrors
``tests/test_cascade.py`` (wiring and ledger contracts) and
``tests/test_cascade_property.py`` (unbiasedness and graceful degradation
under random proxy quality).

Handed the reference's dense weights through ``weights=``, the port runs the
reference's numpy pipeline on the same numbers: estimates, CI bounds and
``oracle_calls`` agree within 1e-12 relative.  On its own weights (a torch
matmul; the streaming regime's fused sweep), a run agrees within
``REL = 1e-6`` with equal ``oracle_calls``, the tolerance of
``tests/test_torch_bas.py``.

The reference's two service tests are mirrored within the port: the
proxy's ``service_group`` is keyed by the tables' content (its fingerprint
``name`` is also held equal to the reference's), and concurrent cascade
queries through one ``OracleService`` equal their serial runs bit for bit,
the proxy stage served under its own ``cascade-proxy`` class.
"""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:  # the seeded fallback below keeps the invariant tested
    HAS_HYPOTHESIS = False

import repro.core as R
import repro.data as RD
import repro_torch.core as P
import repro_torch.data as PD
from repro.core.similarity import chain_weights as ref_chain_weights

EXACT = 1e-12
REL = 1e-6
CFG_R, CFG_P = R.BASConfig(n_bootstrap=100), P.BASConfig(n_bootstrap=100)


def _close(a, b, rel):
    assert a.estimate == pytest.approx(b.estimate, rel=rel, abs=1e-12)
    assert a.ci.lo == pytest.approx(b.ci.lo, rel=rel, abs=1e-12)
    assert a.ci.hi == pytest.approx(b.ci.hi, rel=rel, abs=1e-12)
    assert a.oracle_calls == b.oracle_calls


def _tables(**kw):
    return RD.make_clustered_tables(**kw), PD.make_clustered_tables(**kw)


@pytest.fixture(scope="module")
def ds():
    rds, pds = _tables(n1=80, n2=80, n_entities=120, noise=0.4, seed=3)
    return rds, pds, ref_chain_weights(rds.spec().embeddings)


def _queries(rds, pds, budget=600, proxy=None, agg="COUNT", g=None, **kw):
    """One query per package; ``proxy`` is a numpy label array (each side
    gets its own ``ArrayOracle`` over it) or None for the similarity proxy."""
    def mk(mod, d):
        return mod.Query(
            spec=d.spec(), agg=mod.Agg[agg], oracle=d.oracle(), budget=budget,
            g=g, proxy=None if proxy is None else mod.ArrayOracle(proxy), **kw)
    return mk(R, rds), mk(P, pds)


def _value_g(pds):
    col = pds.columns1["value"]
    return lambda idx: col[idx[:, 0]]


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG"])
@pytest.mark.parametrize("proxy", ["truth", "similarity"])
def test_dense_cascade_on_reference_weights(ds, proxy, agg):
    rds, pds, w = ds
    labels = rds.truth.astype(np.float64) if proxy == "truth" else None
    g = None if agg == "COUNT" else _value_g(pds)
    rq, pq = _queries(rds, pds, proxy=labels, agg=agg, g=g)
    a = P.run_bas_cascade(pq, CFG_P, seed=5, path="dense", weights=w,
                          device="cpu")
    b = R.run_bas_cascade(rq, CFG_R, seed=5, path="dense", weights=w)
    _close(a, b, EXACT)
    ca, cb = a.telemetry.cascade, b.telemetry.cascade
    for f in ("proxy_calls", "proxy_requests", "oracle_calls", "proxy_rows",
              "correction_rows", "disagreement_rate"):
        assert getattr(ca, f) == getattr(cb, f), f
    assert a.telemetry.beta == b.telemetry.beta


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG"])
@pytest.mark.parametrize("path", ["dense", "streaming"])
def test_cascade_on_own_weights(ds, path, agg):
    rds, pds, _ = ds
    g = None if agg == "COUNT" else _value_g(pds)
    rq, pq = _queries(rds, pds, agg=agg, g=g)
    a = P.run_bas_cascade(pq, CFG_P, seed=2, path=path, device="cpu")
    b = R.run_bas_cascade(rq, CFG_R, seed=2, path=path)
    _close(a, b, REL)
    assert a.telemetry.cascade.proxy_calls == b.telemetry.cascade.proxy_calls
    assert a.telemetry.stratify.path == b.telemetry.stratify.path


def test_perfect_proxy_reports_zero_disagreement(ds):
    rds, pds, _ = ds
    truth = float(pds.truth.sum())
    rq, pq = _queries(rds, pds, proxy=rds.truth.astype(np.float64))
    res = P.run_bas_cascade(pq, seed=0, path="dense", device="cpu")
    _close(res, R.run_bas_cascade(rq, seed=0, path="dense"), REL)
    c = res.telemetry.cascade
    assert c is not None
    assert c.disagreement_rate == 0.0
    assert c.proxy_rows > 0 and c.correction_rows > 0
    assert res.ci.contains(truth)


def test_budget_binds_oracle_only_and_ledger_is_consistent(ds):
    rds, pds, _ = ds
    budget = 500
    rq, pq = _queries(rds, pds, budget=budget, proxy=rds.truth.astype(np.float64))
    res = P.run_bas_cascade(pq, seed=1, path="dense", device="cpu")
    _close(res, R.run_bas_cascade(rq, seed=1, path="dense"), REL)
    assert pq.oracle.calls <= budget
    assert pq.oracle.calls == pq.oracle.charged
    assert res.oracle_calls == pq.oracle.calls
    assert res.telemetry.cascade.oracle_calls == pq.oracle.calls
    assert pq.proxy.budget is None
    assert pq.proxy.calls > budget
    assert res.telemetry.cascade.proxy_calls == pq.proxy.calls == rq.proxy.calls


def test_exact_shortcut_when_budget_covers_space(ds):
    _, pds, _ = ds
    _, pq = _queries(pds, pds, budget=pds.spec().n_tuples)
    res = P.run_bas_cascade(pq, seed=0, device="cpu")
    assert res.telemetry.mode == "exact"
    assert res.estimate == float(pds.truth.sum())


def test_nonlinear_aggregate_falls_back_to_plain_bas(ds):
    rds, pds, _ = ds
    rq, pq = _queries(rds, pds, agg="MEDIAN", g=_value_g(pds))
    res = P.run_bas_cascade(pq, seed=0, path="dense", device="cpu")
    assert res.telemetry.mode == "bas"
    assert res.telemetry.cascade is None
    _close(res, R.run_bas_cascade(rq, seed=0, path="dense"), REL)


@pytest.mark.parametrize("cap", [256 * 2**20, 0], ids=["dense", "streaming"])
def test_dispatch_routes_cascade_and_labels_path(ds, cap):
    rds, pds, _ = ds
    rq, pq = _queries(rds, pds, proxy=rds.truth.astype(np.float64))
    a = P.run_auto(pq, P.BASConfig(cascade=True, max_dense_weight_bytes=cap),
                   seed=0, device="cpu")
    b = R.run_auto(rq, R.BASConfig(cascade=True, max_dense_weight_bytes=cap),
                   seed=0)
    _close(a, b, REL)
    assert a.telemetry.mode == "bas-cascade"
    want = "cascade-dense" if cap else "cascade-streaming"
    assert a.telemetry.dispatch.path == b.telemetry.dispatch.path == want
    assert a.telemetry.cascade is not None


def test_dispatch_cascade_nonlinear_falls_through_to_plain(ds):
    rds, pds, _ = ds
    col = pds.columns1["value"]
    rq, pq = _queries(rds, pds, agg="MIN", g=_value_g(pds),
                      g_bounds=(float(col.min()), None))
    res = P.run_auto(pq, P.BASConfig(cascade=True), seed=0, device="cpu")
    assert res.telemetry.mode == "bas"
    assert res.telemetry.dispatch.path == "dense"
    _close(res, R.run_auto(rq, R.BASConfig(cascade=True), seed=0), REL)


def test_streaming_routed_cascade_runs(ds):
    rds, pds, _ = ds
    rq, pq = _queries(rds, pds, proxy=rds.truth.astype(np.float64))
    res = P.run_bas_cascade(pq, seed=2, path="streaming", device="cpu")
    assert res.telemetry.mode == "bas-cascade"
    assert res.telemetry.stratify is not None
    assert res.telemetry.cascade.correction_rows > 0
    _close(res, R.run_bas_cascade(rq, seed=2, path="streaming"), REL)


def _engine(mod, d, **kw):
    cat = mod.Catalog()
    cat.register(mod.Table("t1", d.emb1, d.columns1))
    cat.register(mod.Table("t2", d.emb2, d.columns2))
    pt = d.truth.astype(np.float64)
    return mod.JoinMLEngine(cat, lambda nl, names: d.oracle(),
                            proxy_factory=lambda nl, names: mod.ArrayOracle(pt),
                            **kw)


def test_engine_method_and_proxy_factory(ds):
    rds, pds, _ = ds
    sql = ("SELECT COUNT(*) FROM t1 JOIN t2 ON NL('same entity') "
           "ORACLE BUDGET 600 WITH PROBABILITY 0.95")
    a = _engine(P, pds, device="cpu").execute(sql, method="bas-cascade", seed=4)
    b = _engine(R, rds).execute(sql, method="bas-cascade", seed=4)
    _close(a, b, REL)
    assert a.telemetry.mode == "bas-cascade"
    assert a.telemetry.cascade.disagreement_rate == 0.0


def test_similarity_proxy_name_is_the_reference_fingerprint(ds):
    """The content fingerprint the reference keys its proxy's service group
    on: same tables -> the same ``name`` in both packages, different tables
    -> a different one."""
    rds, pds, _ = ds
    p1 = P.similarity_proxy(pds.spec())
    assert p1.name == R.similarity_proxy(rds.spec()).name
    assert p1.name == P.similarity_proxy(pds.spec()).name
    assert p1.threshold == 0.5
    other = PD.make_clustered_tables(40, 40, n_entities=60, noise=0.4, seed=9)
    assert P.similarity_proxy(other.spec()).name != p1.name
    idx = np.stack(np.unravel_index(np.arange(pds.spec().n_tuples),
                                    pds.spec().sizes), 1)
    np.testing.assert_array_equal(
        p1.label(idx), R.similarity_proxy(rds.spec()).label(idx))


def test_similarity_proxy_service_group_is_content_keyed(ds):
    """The default proxy's service group is fingerprinted from the table
    embeddings: same tables -> same group (cross-query super-batch fusion +
    safe label sharing), different tables -> different group; and it is the
    reference's group for the same tables."""
    rds, pds, _ = ds
    p1 = P.similarity_proxy(pds.spec())
    p2 = P.similarity_proxy(pds.spec())
    assert p1.service_group() == p2.service_group()
    assert p1.service_group()[0] == "scorer"
    assert p1.service_group() == R.similarity_proxy(rds.spec()).service_group()
    other = PD.make_clustered_tables(40, 40, n_entities=60, noise=0.4, seed=9)
    assert P.similarity_proxy(other.spec()).service_group() != p1.service_group()


def test_cascade_telemetry_roundtrip(ds):
    _, pds, _ = ds
    _, pq = _queries(pds, pds, proxy=pds.truth.astype(np.float64))
    res = P.run_bas_cascade(pq, seed=0, path="dense", device="cpu")
    d = res.telemetry.as_detail()
    assert d["cascade"]["proxy_group"] != d["cascade"]["oracle_group"]
    from repro_torch.obs import QueryTelemetry

    rt = QueryTelemetry.from_detail(d)
    assert rt.cascade.proxy_calls == res.telemetry.cascade.proxy_calls
    assert rt.as_detail() == d


def test_similarity_proxy_group_is_the_reference_key(ds):
    rds, pds, _ = ds
    rq, pq = _queries(rds, pds)
    a = P.run_bas_cascade(pq, seed=0, path="dense", device="cpu")
    b = R.run_bas_cascade(rq, seed=0, path="dense")
    assert a.telemetry.cascade.proxy_group == b.telemetry.cascade.proxy_group
    assert "sim-proxy:" in a.telemetry.cascade.proxy_group


def test_index_arguments_raise(ds):
    """Stage 1 stratifies from an index artifact or through an index store
    (ROADMAP item 6), equal to the fresh cascade bit for
    bit; only an artifact that does not cover the query's tables raises."""
    _, pds, _ = ds
    embs = [np.asarray(e, np.float32) for e in pds.spec().embeddings]
    fresh = P.run_bas_cascade(_queries(pds, pds)[1], path="streaming", device="cpu")
    art = P.build_index(embs, device="cpu")
    for kw in (dict(artifact=art), dict(index_store=P.IndexStore(device="cpu"))):
        res = P.run_bas_cascade(_queries(pds, pds)[1], path="streaming",
                                device="cpu", **kw)
        assert res.telemetry.stratify.path == "index"
        assert (res.estimate, res.ci.lo, res.ci.hi) == (
            fresh.estimate, fresh.ci.lo, fresh.ci.hi)
    other = P.build_index([embs[0][:40], embs[1]], device="cpu")
    with pytest.raises(ValueError, match="covers tables"):
        P.run_bas_cascade(_queries(pds, pds)[1], path="streaming", device="cpu",
                          artifact=other)


# ----------------------------------------------------------------------------
# properties (tests/test_cascade_property.py)
# ----------------------------------------------------------------------------

_PROP = _tables(n1=56, n2=56, n_entities=84, noise=0.4, seed=17)
_PROP_W = ref_chain_weights(_PROP[0].spec().embeddings)
_TRUTH = float(_PROP[1].truth.sum())


def _flipped(rate: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    labels = _PROP[1].truth.astype(np.float64).copy()
    flip = rng.random(labels.shape) < rate
    labels[flip] = 1.0 - labels[flip]
    return labels


def _run(seed, flip_rate, flip_seed, budget=350):
    """The port's dense cascade on the reference's weights, held equal to
    the reference's run."""
    rq, pq = _queries(*_PROP, budget=budget, proxy=_flipped(flip_rate, flip_seed))
    res = P.run_bas_cascade(pq, CFG_P, seed=seed, path="dense", weights=_PROP_W,
                            device="cpu")
    _close(res, R.run_bas_cascade(rq, CFG_R, seed=seed, path="dense",
                                  weights=_PROP_W), EXACT)
    return pq, res


def _check_ledger_pacing_and_result_sanity(flip_rate, flip_seed, seed):
    q, res = _run(seed, flip_rate, flip_seed)
    assert q.oracle.calls <= q.budget
    assert q.oracle.calls == q.oracle.charged
    assert res.oracle_calls == q.oracle.calls
    assert q.proxy.budget is None
    assert np.isfinite(res.estimate)
    assert res.ci.lo <= res.estimate <= res.ci.hi
    c = res.telemetry.cascade
    assert 0.0 <= c.disagreement_rate <= 1.0
    assert c.oracle_calls == q.oracle.calls
    assert c.proxy_calls == q.proxy.calls


if HAS_HYPOTHESIS:
    @given(
        flip_rate=st.one_of(st.just(0.0), st.just(1.0), st.floats(0.0, 1.0)),
        flip_seed=st.integers(0, 1000),
        seed=st.integers(0, 1000),
    )
    @settings(max_examples=12, deadline=None)
    def test_ledger_pacing_and_result_sanity(flip_rate, flip_seed, seed):
        _check_ledger_pacing_and_result_sanity(flip_rate, flip_seed, seed)
else:
    @pytest.mark.parametrize(
        "flip_rate,flip_seed,seed",
        [(0.0, 3, 0), (1.0, 5, 1), (0.37, 7, 2)],
    )
    def test_ledger_pacing_and_result_sanity(flip_rate, flip_seed, seed):
        _check_ledger_pacing_and_result_sanity(flip_rate, flip_seed, seed)


@pytest.mark.parametrize("flip_rate", [0.0, 0.5, 1.0])
def test_unbiased_over_seeds_at_proxy_extremes(flip_rate):
    ests = [_run(seed, flip_rate, flip_seed=7)[1].estimate for seed in range(25)]
    se = np.std(ests, ddof=1) / np.sqrt(len(ests))
    assert abs(np.mean(ests) - _TRUTH) < max(4.0 * se, 0.15 * _TRUTH)


def test_garbage_proxy_degrades_gracefully_to_bas_variance():
    n_rep, budget = 25, 350
    casc_err, widths, cover = [], [], 0
    for seed in range(n_rep):
        _, res = _run(seed, flip_rate=0.5, flip_seed=11, budget=budget)
        casc_err.append(res.estimate - _TRUTH)
        widths.append(res.ci.hi - res.ci.lo)
        cover += res.ci.contains(_TRUTH)
        pds = _PROP[1]
        qp = P.Query(spec=pds.spec(), agg=P.Agg.COUNT, oracle=pds.oracle(),
                     budget=budget)
        rp = P.run_bas(qp, CFG_P, seed=seed, device="cpu")
        assert rp.ci.contains(_TRUTH)
    assert cover / n_rep >= 0.80
    rmse_c = float(np.sqrt(np.mean(np.square(casc_err))))
    assert rmse_c <= float(np.mean(widths)) / 2.0 * 2.0


# ----------------------------------------------------------------------------
# OracleService integration (acceptance: bit-identical to serial)
# ----------------------------------------------------------------------------

def _served_queries(seeds):
    out = []
    for s in seeds:
        d = PD.make_clustered_tables(64, 64, n_entities=96, noise=0.4, seed=s)
        out.append(P.Query(spec=d.spec(), agg=P.Agg.COUNT, oracle=d.oracle(),
                           budget=400,
                           proxy=P.ArrayOracle(d.truth.astype(np.float64))))
    return out


def test_served_cascade_bit_identical_to_serial():
    """Concurrent cascade queries through one OracleService produce exactly
    the serial estimates/CIs/ledgers; proxy traffic super-batches under its
    own ``cascade-proxy`` class and shows up in the per-class telemetry.
    The windows' timer only groups flushes (a stage may flush the oracle
    without its proxy); no result depends on it, and every wait is bounded.
    """
    from repro_torch.obs import InMemoryTracker
    from repro_torch.serve.oracle_service import OracleService, serve_queries

    seeds = (1, 2, 3)
    serial = []
    for q, s in zip(_served_queries(seeds), seeds):
        res = P.run_bas_cascade(q, seed=s, path="dense", device="cpu")
        serial.append((res, q.oracle.calls, q.oracle.requests))

    tracker = InMemoryTracker()
    with OracleService(workers=2, max_wait_ms=20.0, tracker=tracker) as svc:
        queries = _served_queries(seeds)
        svc.attach(*[q.oracle for q in queries])

        def job(q, s):
            try:
                return P.run_bas_cascade(q, seed=s, path="dense", device="cpu")
            finally:
                svc.detach(q.oracle)

        results = serve_queries(
            svc, [lambda q=q, s=s: job(q, s) for q, s in zip(queries, seeds)],
            timeout=120.0,
        )
        snap = svc.snapshot()

    for (ref, calls, requests), got, q in zip(serial, results, queries):
        assert got.estimate == ref.estimate          # bit-identical
        assert got.ci.lo == ref.ci.lo and got.ci.hi == ref.ci.hi
        assert q.oracle.calls == calls               # same ledger charge
        assert q.oracle.requests == requests
        # the auto-attached proxy detached with its query
        assert q.proxy.service is None
    # proxy stage landed in its own deadline-class telemetry
    assert snap["service.class.cascade-proxy.flush_ms.count"] > 0.0
