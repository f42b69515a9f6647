"""The port's query engine end to end against the reference, seeded, on
2-way ``make_clustered_tables`` and 3-way ``make_chain_dataset`` inputs:
``run_bas``, ``run_bas_streaming``, ``run_auto`` and ``JoinMLEngine.execute``
on a SQL string, for every method the reference's engine accepts.

Strata membership is checked equal first; then estimates and CI bounds must
agree within 1e-6 relative — the tolerance the reference states between its
own fused and two-pass paths (``core/bas_streaming.py``), which differ by
the same f32 walk-sum rounding the two packages do — and the Oracle must be
charged for the same number of tuples.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.data as RD
import repro_torch.core as P
import repro_torch.data as PD
from repro.core.stratify import stratify_streaming_chain as ref_strat
from repro_torch.core.stratify import stratify_streaming_chain as port_strat
from repro_torch.interop import bas_config_from_dict

REL = 1e-6


def _close(a, b):
    assert a.estimate == pytest.approx(b.estimate, rel=REL)
    assert a.ci.lo == pytest.approx(b.ci.lo, rel=REL, abs=1e-9)
    assert a.ci.hi == pytest.approx(b.ci.hi, rel=REL, abs=1e-9)
    assert a.oracle_calls == b.oracle_calls


def _cfgs(**kw):
    ref = dataclasses.replace(R.BASConfig(n_bootstrap=300), **kw)
    return ref, bas_config_from_dict(dataclasses.asdict(ref))


def _pair():
    kw = dict(n1=150, n2=150, n_entities=80, noise=0.4, seed=5)
    return RD.make_clustered_tables(**kw), PD.make_clustered_tables(**kw)


def _queries(rds, pds, agg, budget):
    col_r, col_p = rds.columns1["value"], pds.columns1["value"]
    g_r = None if agg == "COUNT" else (lambda idx: col_r[idx[:, 0]])
    g_p = None if agg == "COUNT" else (lambda idx: col_p[idx[:, 0]])
    return (R.Query(spec=rds.spec(), agg=R.Agg[agg], oracle=rds.oracle(), g=g_r,
                    budget=budget),
            P.Query(spec=pds.spec(), agg=P.Agg[agg], oracle=pds.oracle(), g=g_p,
                    budget=budget))


def _same_membership(ref_embs, port_embs, rcfg, pcfg, budget, **kw):
    a = ref_strat(ref_embs, rcfg.alpha, budget, rcfg, **kw)
    b = port_strat(port_embs, pcfg.alpha, budget, pcfg, device="cpu", **kw)
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.bounds, b.bounds)


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG", "MEDIAN", "MAX"])
def test_dense_bas_matches_reference(agg):
    rds, pds = _pair()
    rcfg, pcfg = _cfgs()
    rq, pq = _queries(rds, pds, agg, 900)
    _close(P.run_bas(pq, pcfg, seed=3, device="cpu"), R.run_bas(rq, rcfg, seed=3))


STREAMING = [
    dict(),
    dict(use_sweep=False),
    dict(use_kernel=False),
    dict(sweep_precision="bf16"),
    dict(sweep_precision="int8"),
]


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG"])
@pytest.mark.parametrize("kw", STREAMING, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "default")
def test_streaming_bas_matches_reference(agg, kw):
    rds, pds = _pair()
    rcfg, pcfg = _cfgs(**kw)
    _same_membership([rds.emb1, rds.emb2], [pds.emb1, pds.emb2], rcfg, pcfg, 900,
                     use_kernel=rcfg.use_kernel)
    rq, pq = _queries(rds, pds, agg, 900)
    a = P.run_bas_streaming(pq, pcfg, seed=1, device="cpu")
    b = R.run_bas_streaming(rq, rcfg, seed=1)
    _close(a, b)
    assert a.telemetry.stratify.path == b.telemetry.stratify.path
    assert a.telemetry.stratify.extra.get("walk_setup") == \
        b.telemetry.stratify.extra.get("walk_setup")


def test_fused_path_launches_no_standalone_pass():
    from repro_torch.core import similarity

    _, pds = _pair()
    before = dict(similarity.PASS_COUNTS)
    _, pq = _queries(pds, pds, "COUNT", 900)
    P.run_bas_streaming(pq, P.BASConfig(), seed=0, device="cpu")
    assert similarity.PASS_COUNTS == before
    _, pq = _queries(pds, pds, "COUNT", 900)
    P.run_bas_streaming(pq, P.BASConfig(use_sweep=False), seed=0, device="cpu")
    assert similarity.PASS_COUNTS["edge_row_sums"] == before["edge_row_sums"] + 1


@pytest.mark.parametrize("cap", [0, 256 * 2**20])
def test_three_way_chain_matches_reference(cap):
    kw = dict(sizes=[12, 14, 16], d=16, n_entities=8, noise=0.3, seed=1)
    rds, pds = RD.make_chain_dataset(**kw), PD.make_chain_dataset(**kw)
    rcfg, pcfg = _cfgs(max_dense_weight_bytes=cap)
    if cap == 0:
        _same_membership(rds.embeddings, pds.embeddings, rcfg, pcfg, 500,
                         use_kernel=True)
    a = P.run_auto(P.Query(spec=pds.spec(), agg=P.Agg.COUNT, oracle=pds.oracle(),
                           budget=500), pcfg, seed=2, device="cpu")
    b = R.run_auto(R.Query(spec=rds.spec(), agg=R.Agg.COUNT, oracle=rds.oracle(),
                           budget=500), rcfg, seed=2)
    _close(a, b)
    assert a.telemetry.dispatch.path == b.telemetry.dispatch.path == (
        "streaming" if cap == 0 else "dense")


@pytest.mark.parametrize("method", ["auto", "bas", "bas-streaming"])
def test_engine_sql_matches_reference(method):
    rds, pds = _pair()
    rcfg, pcfg = _cfgs(max_dense_weight_bytes=4096)
    sql = ("SELECT AVG(a.ts - b.ts) FROM a JOIN b ON NL('same entity') "
           "ORACLE BUDGET 800 WITH PROBABILITY 0.9")

    def engine(mod, ds, cfg, **kw):
        cat = mod.Catalog()
        cat.register(mod.Table("a", ds.emb1, ds.columns1))
        cat.register(mod.Table("b", ds.emb2, ds.columns2))
        return mod.JoinMLEngine(cat, lambda nl, names: ds.oracle(), cfg=cfg, **kw)

    a = engine(P, pds, pcfg, device="cpu").execute(sql, method=method, seed=4)
    b = engine(R, rds, rcfg).execute(sql, method=method, seed=4)
    _close(a, b)
    assert a.ci.p == b.ci.p == 0.9


@pytest.mark.parametrize("method", ["bas-cascade", "wwj", "uniform", "abae", "blazeit"])
def test_engine_runs_every_reference_method(method):
    """The methods ported with the baselines and the cascade, through
    ``JoinMLEngine.execute`` on the CPU, against the reference's engine on
    the same SQL string (``uniform`` touches no weight and is exact)."""
    rds, pds = _pair()
    rcfg, pcfg = _cfgs()
    sql = ("SELECT SUM(a.value) FROM a JOIN b ON NL('same entity') "
           "ORACLE BUDGET 800 WITH PROBABILITY 0.9")

    def engine(mod, ds, cfg, **kw):
        cat = mod.Catalog()
        cat.register(mod.Table("a", ds.emb1, ds.columns1))
        cat.register(mod.Table("b", ds.emb2, ds.columns2))
        return mod.JoinMLEngine(cat, lambda nl, names: ds.oracle(), cfg=cfg, **kw)

    a = engine(P, pds, pcfg, device="cpu").execute(sql, method=method, seed=4)
    b = engine(R, rds, rcfg).execute(sql, method=method, seed=4)
    if method == "uniform":
        assert (a.estimate, a.ci.lo, a.ci.hi, a.oracle_calls) == \
            (b.estimate, b.ci.lo, b.ci.hi, b.oracle_calls)
    else:
        _close(a, b)
    assert a.telemetry.mode == b.telemetry.mode
    assert a.oracle_calls <= 800


def test_unported_methods_raise():
    """What still raises: an unknown method, and an index artifact that does
    not cover the query's tables.  The persistent stratification index
    itself (an ``index_store``, an ``artifact``; ROADMAP item 6) is ported
    and serves the query."""
    _, pds = _pair()
    cat = P.Catalog()
    cat.register(P.Table("a", pds.emb1))
    cat.register(P.Table("b", pds.emb2))
    eng = P.JoinMLEngine(cat, lambda nl, names: pds.oracle(), device="cpu")
    sql = "SELECT COUNT(*) FROM a JOIN b ON NL('x') ORACLE BUDGET 500"
    with pytest.raises(ValueError, match="unknown method"):
        eng.execute(sql, method="nope")
    store = P.IndexStore(device="cpu")
    indexed = P.JoinMLEngine(cat, lambda nl, names: pds.oracle(), index_store=store,
                             device="cpu")
    assert indexed.execute(sql, method="bas-streaming").telemetry.index.hit is False

    def q():
        return P.Query(spec=pds.spec(), agg=P.Agg.COUNT, oracle=pds.oracle(),
                       budget=500)

    res = P.run_auto(q(), index_store=store, device="cpu")
    assert res.telemetry.dispatch.path == "streaming-index"
    art = P.build_index([pds.emb1[:100], pds.emb2], device="cpu")
    with pytest.raises(ValueError, match="covers tables"):
        P.run_bas_streaming(q(), artifact=art, device="cpu")
