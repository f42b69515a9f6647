"""The port's selection, GroupBy / heavy-hitter and join-order planner
modules (``repro_torch.core.selection`` / ``planner``) against the
reference's, seeded, on the same numpy inputs.  Mirrors
``tests/test_core_selection_planner.py``.

Handed the reference's dense weights through ``weights=``, the port runs the
reference's numpy code on the same numbers: the selected pairs, ``tau_s``,
the counts and their CIs agree within 1e-12 relative and ``oracle_calls``
exactly.  On its own weights (a torch matmul) a BAS cardinality agrees
within ``REL = 1e-6``, the tolerance of ``tests/test_torch_bas.py``; the
UNIFORM provider touches no weight and is exact.
"""
import numpy as np
import pytest

import repro.core as R
import repro.data as RD
import repro_torch.core as P
import repro_torch.data as PD
from repro.core.similarity import chain_weights as ref_chain_weights
from repro_torch.core.planner import Plan

EXACT = 1e-12
REL = 1e-6


def _tables(**kw):
    return RD.make_clustered_tables(**kw), PD.make_clustered_tables(**kw)


def _same_selection(a, b):
    np.testing.assert_array_equal(a.selected_flat, b.selected_flat)
    assert a.tau_s == b.tau_s
    assert a.oracle_calls == b.oracle_calls
    for k in ("beta", "count_b", "gamma_s", "count_s"):
        assert a.detail[k] == pytest.approx(b.detail[k], rel=EXACT), k


def _same_counts(a, b):
    for k in ("counts", "ci_lo", "ci_hi"):
        np.testing.assert_allclose(a[k], b[k], rtol=EXACT, atol=0)
    assert a["oracle_calls"] == b["oracle_calls"]


def test_selection_recall_and_precision():
    rds, pds = _tables(n1=300, n2=300, n_entities=450, noise=0.35, seed=21)
    w = ref_chain_weights(rds.spec().embeddings)
    truth = pds.truth.reshape(-1)
    n_pos = truth.sum()
    assert n_pos > 20
    hits = 0
    for seed in range(4):
        qr = R.Query(spec=rds.spec(), agg=R.Agg.COUNT, oracle=rds.oracle(), budget=8000)
        qp = P.Query(spec=pds.spec(), agg=P.Agg.COUNT, oracle=pds.oracle(), budget=8000)
        res = P.run_bas_selection(qp, recall_target=0.9, seed=seed, weights=w,
                                  device="cpu")
        _same_selection(res, R.run_bas_selection(qr, recall_target=0.9,
                                                 seed=seed, weights=w))
        sel = np.zeros(len(truth), bool)
        sel[res.selected_flat] = True
        hits += truth[sel].sum() / n_pos >= 0.9
    assert hits >= 3


def test_selection_on_own_weights_meets_the_budget():
    """The port's own weights: the reference's structural check (the budget
    holds, the blocked positives are in the output) and the recall target."""
    _, pds = _tables(n1=200, n2=200, n_entities=300, noise=0.3, seed=22)
    q = P.Query(spec=pds.spec(), agg=P.Agg.COUNT, oracle=pds.oracle(), budget=6000)
    res = P.run_bas_selection(q, recall_target=0.8, seed=0, device="cpu")
    assert res.oracle_calls <= 6000
    truth = pds.truth.reshape(-1)
    assert truth[res.selected_flat].sum() / truth.sum() >= 0.8
    assert 0.0 <= res.detail["gamma_s"] <= 1.0


def _skewed():
    rng = np.random.default_rng(5)
    n1, n2 = 400, 50
    truth = np.zeros((n1, n2), np.int8)
    hot = [3, 17, 41]
    for j in range(n2):
        p = 0.25 if j in hot else 0.005
        truth[:, j] = rng.random(n1) < p
    emb1 = rng.standard_normal((n1, 16)).astype(np.float32)
    emb2 = rng.standard_normal((n2, 16)).astype(np.float32)
    base = rng.standard_normal((n2, 16)).astype(np.float32)
    for j in range(n2):
        m = truth[:, j] > 0
        emb1[m] = base[j] + 0.4 * rng.standard_normal((m.sum(), 16))
        emb2[j] = base[j]
    from repro_torch.core.similarity import normalize

    return truth, hot, [normalize(emb1), normalize(emb2)]


def test_topk_heavy_hitters():
    truth, hot, embs = _skewed()
    w = ref_chain_weights(embs)
    out = {}
    for mod in (P, R):
        spec = mod.JoinSpec(embeddings=embs)
        q = mod.Query(spec=spec, agg=mod.Agg.COUNT, oracle=mod.ArrayOracle(truth),
                      budget=6000)
        kw = dict(device="cpu") if mod is P else {}
        out[mod] = mod.run_topk_heavy_hitters(
            q, k_top=3, entity_fn=lambda t: t[:, 1], n_entities=len(embs[1]),
            seed=0, weights=w, **kw)
    _same_counts(out[P], out[R])
    np.testing.assert_array_equal(out[P]["top"], out[R]["top"])
    assert set(out[P]["top"].tolist()) == set(hot)
    assert out[P]["oracle_calls"] <= 6000


def brute_force_plans(lo, hi):
    if lo == hi:
        yield Plan(lo, hi)
        return
    for mid in range(lo, hi):
        for l in brute_force_plans(lo, mid):
            for r in brute_force_plans(mid + 1, hi):
                yield Plan(lo, hi, l, r)


def test_dp_chain_plan_optimal_vs_bruteforce():
    rng = np.random.default_rng(0)
    sizes = [30, 5, 40, 8]
    cards = {}
    for lo in range(4):
        for hi in range(lo, 4):
            cards[(lo, hi)] = (
                float(sizes[lo]) if lo == hi else float(rng.integers(1, 500))
            )
    card = lambda lo, hi: cards[(lo, hi)]  # noqa: E731
    plan = P.dp_chain_plan(4, sizes, card)
    ref = R.dp_chain_plan(4, sizes, card)
    assert plan.order_str() == ref.order_str()
    assert plan.cost == ref.cost
    best_cost = min(
        P.plan_cost_under_truth(p, sizes, card) for p in brute_force_plans(0, 3)
    )
    assert plan.cost == pytest.approx(best_cost)


@pytest.mark.parametrize("provider", ["bas", "uniform"])
def test_planner_with_estimated_cardinalities_beats_bad_plan(provider):
    kw = dict(sizes=[40, 30, 35], d=16, n_entities=12, noise=0.3, seed=4)
    rds, pds = RD.make_chain_dataset(**kw), PD.make_chain_dataset(**kw)
    spec = pds.spec()

    def factory(mod, ds):
        return lambda lo, hi: mod.PairChainOracle(ds.edge_truth[lo:hi])

    if provider == "bas":
        card = P.bas_cardinality_provider(spec, factory(P, pds), 400, seed=0,
                                          device="cpu")
        ref = R.bas_cardinality_provider(rds.spec(), factory(R, rds), 400, seed=0)
        tol = REL
    else:
        card = P.uniform_cardinality_provider(spec, factory(P, pds), 400, seed=0,
                                              device="cpu")
        ref = R.uniform_cardinality_provider(rds.spec(), factory(R, rds), 400, seed=0)
        tol = 0.0
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        assert card(lo, hi) == pytest.approx(ref(lo, hi), rel=tol, abs=0)
    plan = P.dp_chain_plan(3, list(spec.sizes), card)
    assert plan.order_str() == R.dp_chain_plan(3, list(spec.sizes), ref).order_str()

    def true_card(lo, hi):
        prod = None
        for e in range(lo, hi):
            mat = pds.edge_truth[e].astype(np.float64)
            prod = mat if prod is None else prod @ mat
        return float(prod.sum())

    chosen_cost = P.plan_cost_under_truth(plan, list(spec.sizes), true_card)
    worst_cost = max(
        P.plan_cost_under_truth(p, list(spec.sizes), true_card)
        for p in brute_force_plans(0, 2)
    )
    assert chosen_cost <= worst_cost


def test_groupby_counts_close_and_cis_cover():
    rng = np.random.default_rng(12)
    n1, n2, G = 300, 40, 4
    group_of_right = rng.integers(0, G, size=n2)
    ent_left = rng.integers(0, n2, size=n1)
    truth = (ent_left[:, None] == np.arange(n2)[None, :]).astype(np.int8)
    truth |= (((ent_left[:, None] + 1) % n2) == np.arange(n2)[None, :]).astype(np.int8)
    from repro_torch.core.similarity import normalize

    base = rng.standard_normal((n2, 16)).astype(np.float32)
    emb1 = (
        base[ent_left] + base[(ent_left + 1) % n2]
    ) * 0.5 + 0.4 * rng.standard_normal((n1, 16)).astype(np.float32)
    embs = [normalize(emb1), normalize(base)]
    w = ref_chain_weights(embs)
    out = {}
    for mod in (P, R):
        q = mod.Query(spec=mod.JoinSpec(embeddings=embs), agg=mod.Agg.COUNT,
                      oracle=mod.ArrayOracle(truth), budget=6000)
        kw = dict(device="cpu") if mod is P else {}
        out[mod] = mod.run_bas_groupby(q, lambda t: group_of_right[t[:, 1]], G,
                                       seed=0, weights=w, **kw)
    _same_counts(out[P], out[R])
    got = out[P]
    true_counts = np.array(
        [truth[:, group_of_right == g].sum() for g in range(G)], float
    )
    rel_err = np.abs(got["counts"] - true_counts) / np.maximum(true_counts, 1)
    assert rel_err.mean() < 0.35
    covered = ((got["ci_lo"] <= true_counts) & (true_counts <= got["ci_hi"])).mean()
    assert covered >= 0.5
    assert got["oracle_calls"] <= 6000
