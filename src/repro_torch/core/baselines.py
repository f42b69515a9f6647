"""Baselines the paper evaluates against (§7.1).

* UNIFORM       — uniform sampling over the cross product, CLT CI.
* BLOCKING      — Alg. 2: threshold-filtered candidate set, sample if needed.
                  The threshold is calibrated on a validation split to include
                  90% of validation positives (the paper's Ditto-proxy setup).
* WWJ           — Alg. 3: weighted wander join (importance sampling), CLT CI.
* ABAE          — stratified sampling with Neyman-style two-stage allocation
                  treating the join condition as an ML predicate [38].
* BLAZEIT       — uniform sampling + control variates with the similarity
                  score as the (free) proxy variable [35].

Every entry point takes ``device=`` (default ``"cuda"``; raises without a
card).  The dense weights (``similarity.chain_weights``) and WWJ's walk
steps run there; the statistics and every ``rng`` draw stay in numpy, in
the reference package's order, so a run handed the same ``weights`` replays
the reference's draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from .oracle import OracleBatch
from .similarity import chain_weights, flat_to_tuples
from .types import Agg, BASConfig, ConfidenceInterval, Query, QueryResult
from .wander import clt_ci, flat_sample, ht_terms, walk_sample


def _finalize(query: Query, total_mean: float, ci: ConfidenceInterval, n_space: int,
              detail: dict) -> QueryResult:
    return QueryResult(
        estimate=total_mean, ci=ci, oracle_calls=query.oracle.calls,
        detail={**detail, "oracle": query.oracle.stats()},
    )


def run_uniform(query: Query, seed: int = 0, device="cuda") -> QueryResult:
    """Uniform sampling over the cross product with a CLT CI.  It touches no
    embedding, so ``device`` is only resolved (and raises without a card
    unless it is ``"cpu"``), as in every entry point."""
    resolve_device(device)
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    n_space = query.spec.n_tuples
    n = min(query.budget, n_space)
    flat = rng.integers(0, n_space, size=n)
    tup = flat_to_tuples(flat, query.spec.sizes)
    o = query.oracle.label(tup)
    g = query.attr()(tup)
    if query.agg is Agg.COUNT:
        x = o * n_space
    elif query.agg is Agg.SUM:
        x = g * o * n_space
    elif query.agg is Agg.AVG:
        s, s_ci = clt_ci(g * o, query.confidence)
        c, _ = clt_ci(o, query.confidence)
        if c <= 0:
            return _finalize(query, 0.0, ConfidenceInterval(-np.inf, np.inf, query.confidence), n_space, {"mode": "uniform"})
        est = s / c
        # delta-method CI for the ratio
        sv = np.var(g * o, ddof=1) / n
        cv = np.var(o, ddof=1) / n
        cov = np.cov(g * o, o, ddof=1)[0, 1] / n
        var = est**2 * (sv / s**2 + cv / c**2 - 2 * cov / (s * c))
        from scipy import stats

        z = stats.norm.ppf(0.5 + query.confidence / 2)
        half = z * np.sqrt(max(var, 0.0))
        return _finalize(
            query, float(est),
            ConfidenceInterval(float(est - half), float(est + half), query.confidence),
            n_space, {"mode": "uniform"},
        )
    else:
        m = o > 0
        vals = g[m]
        est = float(vals.max()) if (query.agg is Agg.MAX and m.any()) else (
            float(vals.min()) if (query.agg is Agg.MIN and m.any()) else float("nan")
        )
        return _finalize(query, est, ConfidenceInterval(est, est, query.confidence),
                         n_space, {"mode": "uniform"})
    mu, ci = clt_ci(x, query.confidence)
    return _finalize(query, mu, ci, n_space, {"mode": "uniform"})


def run_wwj(query: Query, cfg: Optional[BASConfig] = None, seed: int = 0,
            weights: Optional[np.ndarray] = None, device="cuda") -> QueryResult:
    """Standalone Weighted Wander Join (Alg. 3).

    With ``weights`` (flat scores over the cross product, e.g. the Syn
    datasets) WWJ samples the statistically equivalent flat importance
    distribution instead of per-step walks.  The walks' weight blocks are
    computed and sampled on ``device``."""
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    n = query.budget
    if weights is not None:
        pos, p = flat_sample(np.asarray(weights, np.float64), n, rng)
        from .wander import WalkSample

        ws = WalkSample(idx=flat_to_tuples(pos, query.spec.sizes), prob=p)
    else:
        ws = walk_sample(
            [np.asarray(e) for e in query.spec.embeddings],
            n, rng, cfg.weight_exponent, cfg.weight_floor, device=device,
        )
    o = query.oracle.label(ws.idx)
    g = query.attr()(ws.idx)
    if query.agg is Agg.COUNT:
        x = ht_terms(o, ws.prob)
    elif query.agg is Agg.SUM:
        x = ht_terms(g * o, ws.prob)
    elif query.agg is Agg.AVG:
        xs = ht_terms(g * o, ws.prob)
        xc = ht_terms(o, ws.prob)
        s, c = xs.mean(), xc.mean()
        if c <= 0:
            return _finalize(query, 0.0, ConfidenceInterval(-np.inf, np.inf, query.confidence), 0, {"mode": "wwj"})
        est = s / c
        sv, cv = np.var(xs, ddof=1) / n, np.var(xc, ddof=1) / n
        cov = np.cov(xs, xc, ddof=1)[0, 1] / n
        var = est**2 * (sv / s**2 + cv / c**2 - 2 * cov / (s * c))
        from scipy import stats

        z = stats.norm.ppf(0.5 + query.confidence / 2)
        half = z * np.sqrt(max(var, 0.0))
        return _finalize(query, float(est),
                         ConfidenceInterval(float(est - half), float(est + half), query.confidence),
                         0, {"mode": "wwj"})
    else:
        m = o > 0
        vals = g[m]
        est = float(vals.max()) if (query.agg is Agg.MAX and m.any()) else (
            float(vals.min()) if (query.agg is Agg.MIN and m.any()) else float("nan"))
        return _finalize(query, est, ConfidenceInterval(est, est, query.confidence), 0, {"mode": "wwj"})
    mu, ci = clt_ci(x, query.confidence)
    return _finalize(query, mu, ci, 0, {"mode": "wwj"})


def calibrate_threshold(
    val_weights: np.ndarray, val_labels: np.ndarray, target_recall: float = 0.9
) -> float:
    """Blocking threshold including ``target_recall`` of validation positives."""
    pos = val_weights[val_labels > 0]
    if len(pos) == 0:
        return 0.0
    return float(np.quantile(pos, 1.0 - target_recall))


def run_blocking(
    query: Query,
    threshold: float,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> QueryResult:
    """Alg. 2: embedding-based blocking with a predefined Oracle budget.

    Biased by construction (false negatives below tau are never corrected) —
    the failure mode Figures 2/5 demonstrate.
    """
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if weights is None:
        weights = chain_weights(query.spec.embeddings, cfg.weight_exponent,
                                cfg.weight_floor, device=device)
    cand = np.nonzero(weights >= threshold)[0]
    n_cand = len(cand)
    from scipy import stats

    z = stats.norm.ppf(0.5 + query.confidence / 2)
    if n_cand <= query.budget:
        tup = flat_to_tuples(cand, query.spec.sizes)
        o = query.oracle.label(tup)
        g = query.attr()(tup)
        if query.agg is Agg.COUNT:
            est = float(o.sum())
        elif query.agg is Agg.SUM:
            est = float((g * o).sum())
        else:
            est = float((g * o).sum() / max(o.sum(), 1e-12))
        return _finalize(query, est, ConfidenceInterval(est, est, query.confidence),
                         n_cand, {"mode": "blocking", "n_candidates": n_cand})
    sel = rng.choice(n_cand, size=query.budget, replace=False)
    tup = flat_to_tuples(cand[sel], query.spec.sizes)
    o = query.oracle.label(tup)
    g = query.attr()(tup)
    n = query.budget
    if query.agg is Agg.COUNT:
        x = o * n_cand
    elif query.agg is Agg.SUM:
        x = g * o * n_cand
    else:
        s, c = float((g * o).mean()), float(o.mean())
        est = s / max(c, 1e-12)
        var = np.var(g * o - est * o, ddof=1) / n / max(c, 1e-12) ** 2
        half = z * np.sqrt(max(var, 0.0))
        return _finalize(query, est, ConfidenceInterval(est - half, est + half, query.confidence),
                         n_cand, {"mode": "blocking", "n_candidates": n_cand})
    mu, ci = clt_ci(x, query.confidence)
    return _finalize(query, mu, ci, n_cand, {"mode": "blocking", "n_candidates": n_cand})


def run_abae(query: Query, cfg: Optional[BASConfig] = None, seed: int = 0,
             weights: Optional[np.ndarray] = None, device="cuda") -> QueryResult:
    """ABAE-style stratified sampling [38]: stratify the *whole* space by proxy
    score, pilot for per-stratum std, Neyman allocation n_i ∝ |D_i| sigma_i,
    uniform sampling within strata (no importance weighting, no blocking)."""
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if weights is None:
        weights = chain_weights(query.spec.embeddings, cfg.weight_exponent,
                                cfg.weight_floor, device=device)
    n_space = query.spec.n_tuples
    k = 5
    qs = np.quantile(weights, np.linspace(0, 1, k + 1)[1:-1])
    stratum_of = np.searchsorted(qs, weights)
    b1 = max(int(0.3 * query.budget), 2 * k)
    b2 = query.budget - b1
    samples, sizes = [], []
    sig = np.zeros(k)
    per_idx = [np.nonzero(stratum_of == i)[0] for i in range(k)]
    pilot_per = max(b1 // k, 2)
    # pilot: one coalesced Oracle batch across all strata
    pilot_batch = OracleBatch(query.oracle)
    pilot_reqs: list = []
    for i in range(k):
        if len(per_idx[i]) == 0:
            pilot_reqs.append(None)
            continue
        sel = rng.integers(0, len(per_idx[i]), size=min(pilot_per, b1))
        tup = flat_to_tuples(per_idx[i][sel], query.spec.sizes)
        pilot_reqs.append((tup, pilot_batch.submit(tup)))
    pilot_batch.flush_async().result()   # one coalesced flush for the pilot
    pilot_data = []
    for i in range(k):
        if pilot_reqs[i] is None:
            pilot_data.append((np.zeros(0), np.zeros(0)))
            continue
        tup, h = pilot_reqs[i]
        o = h.labels
        g = query.attr()(tup)
        v = g * o if query.agg in (Agg.SUM, Agg.AVG) else o
        sig[i] = np.std(v, ddof=1) if len(v) > 1 else 0.0
        pilot_data.append((o, g))
    sizes = np.array([len(ix) for ix in per_idx], np.float64)
    alloc = sizes * sig
    alloc = alloc / max(alloc.sum(), 1e-300) * b2
    # main: one coalesced Oracle batch across all strata
    main_batch = OracleBatch(query.oracle)
    main_reqs: list = [None] * k
    for i in range(k):
        if len(per_idx[i]) == 0:
            continue
        n_i = int(alloc[i])
        if n_i > 0:
            sel = rng.integers(0, len(per_idx[i]), size=n_i)
            tup = flat_to_tuples(per_idx[i][sel], query.spec.sizes)
            main_reqs[i] = (tup, main_batch.submit(tup))
    main_batch.flush_async().result()
    est, var = 0.0, 0.0
    est_c, var_c = 0.0, 0.0
    for i in range(k):
        if len(per_idx[i]) == 0:
            continue
        o, g = pilot_data[i]
        if main_reqs[i] is not None:
            tup, h = main_reqs[i]
            o = np.concatenate([o, h.labels])
            g = np.concatenate([g, query.attr()(tup)])
        if len(o) == 0:
            continue
        v = g * o if query.agg in (Agg.SUM, Agg.AVG) else o
        est += sizes[i] * v.mean()
        var += sizes[i] ** 2 * (np.var(v, ddof=1) / len(v) if len(v) > 1 else 0.0)
        est_c += sizes[i] * o.mean()
        var_c += sizes[i] ** 2 * (np.var(o, ddof=1) / len(o) if len(o) > 1 else 0.0)
    from scipy import stats

    z = stats.norm.ppf(0.5 + query.confidence / 2)
    if query.agg is Agg.AVG:
        if est_c <= 0:
            return _finalize(query, 0.0, ConfidenceInterval(-np.inf, np.inf, query.confidence), n_space, {"mode": "abae"})
        r = est / est_c
        var_r = r**2 * (var / max(est**2, 1e-300) + var_c / max(est_c**2, 1e-300))
        half = z * np.sqrt(max(var_r, 0.0))
        return _finalize(query, float(r), ConfidenceInterval(r - half, r + half, query.confidence), n_space, {"mode": "abae"})
    half = z * np.sqrt(max(var, 0.0))
    return _finalize(query, float(est), ConfidenceInterval(est - half, est + half, query.confidence),
                     n_space, {"mode": "abae"})


def run_blazeit(query: Query, cfg: Optional[BASConfig] = None, seed: int = 0,
                weights: Optional[np.ndarray] = None, device="cuda") -> QueryResult:
    """BlazeIt-style control variates [35]: uniform sample, similarity score as
    control variate with known population mean."""
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if weights is None:
        weights = chain_weights(query.spec.embeddings, cfg.weight_exponent,
                                cfg.weight_floor, device=device)
    n_space = query.spec.n_tuples
    n = min(query.budget, n_space)
    flat = rng.integers(0, n_space, size=n)
    tup = flat_to_tuples(flat, query.spec.sizes)
    o = query.oracle.label(tup)
    g = query.attr()(tup)
    w = weights[flat]
    w_mean = float(weights.mean())
    y = (g * o if query.agg in (Agg.SUM, Agg.AVG) else o) * 1.0
    if np.var(w) > 0:
        c = float(np.cov(y, w, ddof=1)[0, 1] / np.var(w, ddof=1))
    else:
        c = 0.0
    adj = y - c * (w - w_mean)
    if query.agg is Agg.AVG:
        oc = o - (float(np.cov(o, w, ddof=1)[0, 1] / np.var(w, ddof=1)) if np.var(w) > 0 else 0.0) * (w - w_mean)
        s, cc = adj.mean(), oc.mean()
        if cc <= 0:
            return _finalize(query, 0.0, ConfidenceInterval(-np.inf, np.inf, query.confidence), n_space, {"mode": "blazeit"})
        est = s / cc
        var = est**2 * (np.var(adj, ddof=1) / n / s**2 + np.var(oc, ddof=1) / n / cc**2)
        from scipy import stats

        z = stats.norm.ppf(0.5 + query.confidence / 2)
        half = z * np.sqrt(max(var, 0.0))
        return _finalize(query, float(est), ConfidenceInterval(est - half, est + half, query.confidence), n_space, {"mode": "blazeit"})
    mu, ci = clt_ci(adj * n_space, query.confidence)
    return _finalize(query, mu, ci, n_space, {"mode": "blazeit"})
