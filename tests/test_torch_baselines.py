"""The port's baselines (``repro_torch.core.baselines``) against the
reference's (``repro.core.baselines``), seeded, on the same numpy inputs.
Mirrors ``tests/test_core_baselines.py``.

Three rules:

- handed the reference's weights through ``weights=``, every draw and every
  statistic is the reference's numpy code on the same numbers: estimates,
  CI bounds and ``oracle_calls`` agree within 1e-12 relative;
- ``run_uniform`` touches no weight and must be exact;
- on their own weights (a torch matmul, not XLA's: other f32 bits), runs
  agree within ``REL = 1e-6`` with equal ``oracle_calls``, the tolerance of
  ``tests/test_torch_bas.py``.
"""
import numpy as np
import pytest

import repro.core as R
import repro.data as RD
import repro_torch.core as P
import repro_torch.data as PD
from repro.core.similarity import chain_weights as ref_chain_weights

EXACT = 1e-12
REL = 1e-6
AGGS = ["COUNT", "SUM", "AVG"]


def _close(a, b, rel):
    assert a.estimate == pytest.approx(b.estimate, rel=rel, abs=1e-12)
    assert a.ci.lo == pytest.approx(b.ci.lo, rel=rel, abs=1e-12)
    assert a.ci.hi == pytest.approx(b.ci.hi, rel=rel, abs=1e-12)
    assert a.oracle_calls == b.oracle_calls


def _same(a, b):
    assert (a.estimate, a.ci.lo, a.ci.hi, a.oracle_calls) == \
        (b.estimate, b.ci.lo, b.ci.hi, b.oracle_calls)


def _pair(**kw):
    kw = {**dict(n1=200, n2=200, n_entities=250, noise=0.4, seed=11), **kw}
    return RD.make_clustered_tables(**kw), PD.make_clustered_tables(**kw)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def ref_weights(pair):
    return ref_chain_weights(pair[0].spec().embeddings)


def _queries(rds, pds, agg="COUNT", budget=3000):
    col_r, col_p = rds.columns1["value"], pds.columns1["value"]
    g_r = None if agg == "COUNT" else (lambda idx: col_r[idx[:, 0]])
    g_p = None if agg == "COUNT" else (lambda idx: col_p[idx[:, 0]])
    return (R.Query(spec=rds.spec(), agg=R.Agg[agg], oracle=rds.oracle(),
                    budget=budget, g=g_r),
            P.Query(spec=pds.spec(), agg=P.Agg[agg], oracle=pds.oracle(),
                    budget=budget, g=g_p))


@pytest.mark.parametrize("agg", AGGS + ["MAX", "MIN"])
def test_uniform_is_exact(pair, agg):
    rq, pq = _queries(*pair, agg)
    _same(P.run_uniform(pq, seed=3, device="cpu"), R.run_uniform(rq, seed=3))


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("name", ["run_abae", "run_blazeit"])
def test_abae_blazeit_on_reference_weights(pair, ref_weights, name, agg):
    rq, pq = _queries(*pair, agg, budget=4000)
    a = getattr(P, name)(pq, seed=2, weights=ref_weights, device="cpu")
    b = getattr(R, name)(rq, seed=2, weights=ref_weights)
    _close(a, b, EXACT)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("name", ["run_abae", "run_blazeit"])
def test_abae_blazeit_on_own_weights(pair, name, agg):
    rq, pq = _queries(*pair, agg, budget=4000)
    _close(getattr(P, name)(pq, seed=2, device="cpu"),
           getattr(R, name)(rq, seed=2), REL)


@pytest.mark.parametrize("agg", AGGS)
def test_wwj_walk_mode_on_own_weights(pair, agg):
    rq, pq = _queries(*pair, agg, budget=4000)
    a = P.run_wwj(pq, seed=0, device="cpu")
    b = R.run_wwj(rq, seed=0)
    _close(a, b, REL)
    assert a.ci.lo <= a.estimate <= a.ci.hi


@pytest.mark.parametrize("agg", AGGS)
def test_wwj_flat_weights_mode(agg):
    kw = dict(n1=200, n2=200, selectivity=5e-3, seed=5)
    rds, pds = RD.make_syn_scores(**kw), PD.make_syn_scores(**kw)
    np.testing.assert_array_equal(rds.weights_override, pds.weights_override)
    rq, pq = _queries(rds, pds, agg)
    a = P.run_wwj(pq, seed=0, weights=rds.weights_override, device="cpu")
    b = R.run_wwj(rq, seed=0, weights=rds.weights_override)
    _close(a, b, EXACT)
    if agg == "COUNT":  # the reference's own check
        truth = float(pds.truth.sum())
        assert abs(a.estimate - truth) / truth < 0.4


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("budget", [60, 4000], ids=["sampled", "exhaustive"])
def test_blocking_on_reference_and_own_weights(pair, ref_weights, budget, agg):
    """Both branches of Alg. 2: the candidate set fits the budget (labelled
    exhaustively) or is sampled without replacement."""
    rds, pds = pair
    tau = R.calibrate_threshold(ref_weights, rds.truth.reshape(-1), 0.9)
    assert P.calibrate_threshold(ref_weights, pds.truth.reshape(-1), 0.9) == tau
    rq, pq = _queries(rds, pds, agg, budget)
    a = P.run_blocking(pq, tau, seed=4, weights=ref_weights, device="cpu")
    b = R.run_blocking(rq, tau, seed=4, weights=ref_weights)
    _close(a, b, EXACT)
    n_cand = a.telemetry.extra["n_candidates"]
    assert n_cand == b.telemetry.extra["n_candidates"]
    assert (n_cand > budget) == (budget == 60)
    rq, pq = _queries(rds, pds, agg, budget)
    _close(P.run_blocking(pq, tau, seed=4, device="cpu"),
           R.run_blocking(rq, tau, seed=4), REL)


def test_uniform_unbiased_ish(pair):
    rds, pds = pair
    truth = float(pds.truth.sum())
    ests = []
    for s in range(10):
        rq, pq = _queries(rds, pds)
        a = P.run_uniform(pq, seed=s, device="cpu")
        _same(a, R.run_uniform(rq, seed=s))
        ests.append(a.estimate)
    assert abs(np.mean(ests) - truth) / truth < 0.35


def test_blocking_biased_under_false_negatives():
    """The paper's Fig. 2/5 failure mode, on the port: with false negatives,
    blocking underestimates systematically and its CI misses the truth —
    each run equal to the reference's."""
    kw = dict(selectivity=5e-3, fnr=0.05, fpr=0.0)
    rds = RD.make_syn_scores(300, 300, seed=9, **kw)
    pds = PD.make_syn_scores(300, 300, seed=9, **kw)
    truth = float(pds.truth.sum())
    val = PD.make_syn_scores(300, 300, seed=10, **kw)
    tau = P.calibrate_threshold(val.weights_override, val.truth_flat(), 0.9)
    ests, misses = [], 0
    for seed in range(5):
        rq, pq = _queries(rds, pds, budget=20000)
        a = P.run_blocking(pq, threshold=tau, seed=seed,
                           weights=pds.weights_override, device="cpu")
        _close(a, R.run_blocking(rq, threshold=tau, seed=seed,
                                 weights=rds.weights_override), EXACT)
        ests.append(a.estimate)
        misses += not a.ci.contains(truth)
    assert np.mean(ests) < truth * 0.97
    assert misses >= 3


def test_abae_and_blazeit_run(pair):
    truth = float(pair[1].truth.sum())
    for name in ("run_abae", "run_blazeit"):
        _, pq = _queries(*pair, budget=4000)
        r = getattr(P, name)(pq, seed=0, device="cpu")
        assert np.isfinite(r.estimate)
        assert r.oracle_calls <= 4000
        assert abs(r.estimate - truth) / truth < 2.0


def test_blazeit_variance_not_worse_than_uniform():
    rds, pds = _pair(n1=150, n2=150, n_entities=40, noise=0.35, seed=3)
    truth = float(pds.truth.sum())
    uni, blz = [], []
    for s in range(12):
        rq, pq = _queries(rds, pds, budget=2000)
        uni.append(P.run_uniform(pq, seed=s, device="cpu").estimate)
        rq, pq = _queries(rds, pds, budget=2000)
        b = P.run_blazeit(pq, seed=s, device="cpu")
        _close(b, R.run_blazeit(rq, seed=s), REL)
        blz.append(b.estimate)
    rmse_u = np.sqrt(np.mean((np.array(uni) - truth) ** 2))
    rmse_b = np.sqrt(np.mean((np.array(blz) - truth) ** 2))
    assert rmse_b <= rmse_u * 1.3


def test_dequantize_rows_int8_matches_reference():
    from repro.core.similarity import dequantize_rows_int8 as ref_deq
    from repro_torch.core.similarity import dequantize_rows_int8, quantize_rows_int8

    e = np.random.default_rng(0).standard_normal((33, 20)).astype(np.float32)
    e[3] = 0.0
    q, rs = quantize_rows_int8(e)
    out = dequantize_rows_int8(q, rs)
    np.testing.assert_array_equal(out, ref_deq(q, rs))
    assert np.abs(out - e).max() <= 0.5 * rs.max() * (1 + 1e-6)
