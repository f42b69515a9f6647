"""BAS for selection queries with recall guarantees (paper §5.4, Lemma 5.1)
and Top-K heavy hitters.

Selection semantics (SUPG [37]): output T' such that
P[|T ∩ T'| / |T| >= gamma] >= p.  The score of a pair is its similarity; the
output is {blocked positives} ∪ {pairs with score >= tau_s}.  BAS improves
precision by labelling the blocking regime exactly, which lets tau_s rise:
the sampling regime only needs recall

    gamma_s >= gamma - (1 - gamma) * COUNT_b / UB(COUNT_s)   (Lemma 5.1)

Both entry points are dense: they materialise the chain weights with
``similarity.chain_weights`` on ``device=`` (default ``"cuda"``; raises
without a card).  Sampling and the statistics stay in numpy, in the
reference package's order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..device import resolve_device
from .oracle import OracleBatch
from .similarity import chain_weights, flat_to_tuples
from .stratify import stratify_dense
from .types import BASConfig, Query
from .wander import flat_sample


def upper_bound(mu: float, var: float, n: int, p: float) -> float:
    """UB(mu, sigma^2, b, p) from Lemma 5.1 (normal-approximation bound)."""
    if n <= 0:
        return float("inf")
    return mu + np.sqrt(max(var, 0.0)) * np.sqrt(2.0 * np.log(2.0 / (1.0 - p)))


@dataclasses.dataclass
class SelectionResult:
    selected_flat: np.ndarray
    tau_s: float
    oracle_calls: int
    detail: dict


def run_bas_selection(
    query: Query,
    recall_target: float,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> SelectionResult:
    """Two-table selection with recall guarantee.

    1. stratify; pilot-sample strata for per-stratum COUNT estimates;
    2. block the strata that maximise COUNT_b per budget (greedy by estimated
       positive density — the arg-max of Lemma 5.1's bound);
    3. translate gamma -> gamma_s; estimate the score threshold tau_s whose
       sampling-regime recall is >= gamma_s with confidence p (importance-
       weighted quantile of positive scores, conservative side).
    """
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if weights is None:
        weights = chain_weights(query.spec.embeddings, cfg.weight_exponent,
                                cfg.weight_floor, device=device)
    b = query.budget
    b1 = max(int(round(cfg.pilot_fraction * b)), 8)
    strat = stratify_dense(weights, cfg.alpha, b, cfg)
    k = strat.num_strata
    sizes = strat.stratum_sizes()
    per_idx = [None] + [strat.stratum_indices(i) for i in range(1, k + 1)]
    w0 = np.array(weights, np.float64, copy=True)
    w0[strat.order] = 0.0

    # ---- pilot: estimated positive count + variance per stratum ----------
    count_hat = np.zeros(k + 1)
    count_var = np.zeros(k + 1)
    pilot_scores, pilot_labels, pilot_q, pilot_sid = [], [], [], []
    n_pilot = max(b1 // (k + 1), 2)
    pilot_batch = OracleBatch(query.oracle)
    pilot_draws = []  # (i, pos, q, handle): one coalesced flush for the pilot
    for i in range(k + 1):
        if i == 0:
            if sizes[0] == 0 or w0.sum() <= 0:
                continue
            pos, q = flat_sample(w0, n_pilot, rng)
        else:
            if len(per_idx[i]) == 0:
                continue
            p_, q = flat_sample(weights[per_idx[i]], n_pilot, rng)
            pos = per_idx[i][p_]
        tup = flat_to_tuples(pos, query.spec.sizes)
        pilot_draws.append((i, pos, q, pilot_batch.submit(tup)))
    pilot_batch.flush_async().result()   # one coalesced flush for the pilot
    for i, pos, q, h in pilot_draws:
        o = h.labels
        t = o / q
        count_hat[i] = t.mean()
        count_var[i] = np.var(t, ddof=1) / n_pilot if n_pilot > 1 else 0.0
        pilot_scores.append(weights[pos])
        pilot_labels.append(o)
        pilot_q.append(q)
        pilot_sid.append(np.full(len(o), i))

    # ---- block highest-density strata within remaining budget -------------
    remaining = b - query.oracle.calls
    density = np.zeros(k + 1)
    for i in range(1, k + 1):
        if sizes[i] > 0:
            density[i] = count_hat[i] / sizes[i]
    order = np.argsort(density[1:])[::-1] + 1
    beta, cost = [], 0
    for i in order:
        if density[i] <= 0:
            break
        if cost + sizes[i] <= 0.8 * remaining:
            beta.append(int(i))
            cost += int(sizes[i])
    blocked_pos_flat = []
    count_b = 0.0
    block_batch = OracleBatch(query.oracle)
    block_handles = [
        block_batch.submit(flat_to_tuples(per_idx[i], query.spec.sizes))
        for i in beta
    ]
    block_batch.flush_async().result()
    for i, h in zip(beta, block_handles):
        o = h.labels
        count_b += float(o.sum())
        blocked_pos_flat.append(per_idx[i][o > 0])

    # ---- main sampling round over non-blocked strata ----------------------
    remaining = b - query.oracle.calls
    sampled_ids = [i for i in range(k + 1) if i not in beta and sizes[i] > 0]
    scores, labels, qs = (
        [np.concatenate(pilot_scores)] if pilot_scores else [],
        [np.concatenate(pilot_labels)] if pilot_labels else [],
        [np.concatenate(pilot_q)] if pilot_q else [],
    )
    sids = [np.concatenate(pilot_sid)] if pilot_sid else []
    if remaining > len(sampled_ids) and sampled_ids:
        per = remaining // len(sampled_ids)
        main_batch = OracleBatch(query.oracle)
        main_draws = []  # (i, pos, q, handle)
        for i in sampled_ids:
            if i == 0:
                if w0.sum() <= 0:
                    continue
                pos, q = flat_sample(w0, per, rng)
            else:
                p_, q = flat_sample(weights[per_idx[i]], per, rng)
                pos = per_idx[i][p_]
            tup = flat_to_tuples(pos, query.spec.sizes)
            main_draws.append((i, pos, q, main_batch.submit(tup)))
        main_batch.flush_async().result()
        for i, pos, q, h in main_draws:
            o = h.labels
            scores.append(weights[pos])
            labels.append(o)
            qs.append(q)
            sids.append(np.full(len(o), i))
    sc = np.concatenate(scores) if scores else np.zeros(0)
    lb = np.concatenate(labels) if labels else np.zeros(0)
    qq = np.concatenate(qs) if qs else np.ones(0)
    sid = np.concatenate(sids) if sids else np.zeros(0)
    keep = ~np.isin(sid, list(beta))  # pilot samples of now-blocked strata drop out
    sc, lb, qq = sc[keep], lb[keep], qq[keep]

    # COUNT_s estimate over the sampling regime (importance weighted)
    ht = lb / qq
    count_s = float(ht.mean()) if len(ht) else 0.0
    var_s = float(np.var(ht, ddof=1) / len(ht)) if len(ht) > 1 else 0.0
    ub = upper_bound(count_s, var_s, len(ht), query.confidence)
    gamma_s = recall_target - (1 - recall_target) * count_b / max(ub, 1e-12)
    gamma_s = min(max(gamma_s, 0.0), 1.0)

    # tau_s: importance-weighted quantile of positive scores such that the
    # weighted mass of positives above tau_s >= gamma_s (conservative: lower
    # confidence bound via Waudby-Smith-style normal approx on the mass).
    pos_m = lb > 0
    if pos_m.sum() == 0 or gamma_s <= 0:
        tau_s = 0.0 if gamma_s > 0 else float("inf")
    else:
        v = sc[pos_m]
        w_ht = (1.0 / qq[pos_m])
        order_v = np.argsort(v)[::-1]  # descending score
        v_sorted = v[order_v]
        mass = np.cumsum(w_ht[order_v])
        total = float(ht.sum())
        # add slack ∝ estimator std to be conservative
        slack = np.sqrt(max(var_s, 0.0)) * len(ht) / max(total, 1e-12)
        frac = mass / max(total, 1e-12) + slack
        j = np.nonzero(frac >= gamma_s)[0]
        tau_s = float(v_sorted[j[0]]) if len(j) else 0.0

    selected = [np.nonzero((weights >= tau_s) & (w0 > 0))[0]] + blocked_pos_flat
    # strata not blocked but inside the blocking regime: include via threshold
    for i in sampled_ids:
        if i == 0:
            continue
        m = weights[per_idx[i]] >= tau_s
        selected.append(per_idx[i][m])
    sel = np.unique(np.concatenate(selected)) if selected else np.zeros(0, np.int64)
    return SelectionResult(
        selected_flat=sel,
        tau_s=tau_s,
        oracle_calls=query.oracle.calls,
        detail={"beta": beta, "count_b": count_b, "gamma_s": gamma_s,
                "count_s": count_s, "oracle": query.oracle.stats()},
    )


def run_bas_groupby(
    query: Query,
    group_fn,
    n_groups: int,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> dict:
    """GroupBy COUNT (paper §5.3 "Handling GroupBy"): per-group combined
    estimates from one BAS execution; blocking prioritises strata with high
    densities of small ("hard-to-estimate") groups via the heavy-hitter
    machinery; simultaneous CIs are Bonferroni-adjusted bootstrap intervals."""
    out = run_topk_heavy_hitters(
        query, k_top=n_groups, entity_fn=group_fn, n_entities=n_groups,
        cfg=cfg, seed=seed, weights=weights, device=device,
    )
    return {
        "counts": out["counts"],
        "ci_lo": out["ci_lo"],
        "ci_hi": out["ci_hi"],
        "oracle_calls": out["oracle_calls"],
    }


def run_topk_heavy_hitters(
    query: Query,
    k_top: int,
    entity_fn,
    n_entities: int,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> dict:
    """Top-K heavy hitters (paper §5.4): per-entity COUNT via the combined
    estimator; return K entities with largest estimates + simultaneous
    bootstrap CIs (Bonferroni over candidates near the boundary)."""

    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)
    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if weights is None:
        weights = chain_weights(query.spec.embeddings, cfg.weight_exponent,
                                cfg.weight_floor, device=device)
    b = query.budget
    strat = stratify_dense(weights, cfg.alpha, b, cfg)
    kk = strat.num_strata
    sizes = strat.stratum_sizes()
    per_idx = [None] + [strat.stratum_indices(i) for i in range(1, kk + 1)]
    w0 = np.array(weights, np.float64, copy=True)
    w0[strat.order] = 0.0
    # block the top strata (highest similarity first) within half the budget,
    # sample the rest ∝ weight
    beta, cost = [], 0
    for i in range(1, kk + 1):
        if cost + sizes[i] <= 0.5 * b:
            beta.append(i)
            cost += int(sizes[i])
    counts = np.zeros(n_entities)
    n_boot = 200
    boot = np.zeros((n_boot, n_entities))
    blocked_counts = np.zeros(n_entities)
    block_batch = OracleBatch(query.oracle)
    block_tups = [flat_to_tuples(per_idx[i], query.spec.sizes) for i in beta]
    block_handles = [block_batch.submit(tup) for tup in block_tups]
    block_fut = block_batch.flush_async()
    ents = [entity_fn(tup).astype(np.int64) for tup in block_tups]
    block_fut.result()                   # entity ids computed during labelling
    for ent, h in zip(ents, block_handles):
        o = h.labels
        np.add.at(blocked_counts, ent[o > 0], 1.0)
    counts += blocked_counts
    remaining = b - query.oracle.calls
    sampled_ids = [i for i in range(kk + 1) if i not in beta and sizes[i] > 0]
    main_batch = OracleBatch(query.oracle)
    main_draws = []  # (tup, q, n_i, handle)
    for i in sampled_ids:
        n_i = remaining // max(len(sampled_ids), 1)
        if n_i < 2:
            continue
        if i == 0:
            if w0.sum() <= 0:
                continue
            pos, q = flat_sample(w0, n_i, rng)
        else:
            p_, q = flat_sample(weights[per_idx[i]], n_i, rng)
            pos = per_idx[i][p_]
        tup = flat_to_tuples(pos, query.spec.sizes)
        # bootstrap indices drawn here to keep the rng stream identical to the
        # pre-batching (label-inside-the-loop) execution order
        ridx = rng.integers(0, n_i, size=(200, n_i))
        main_draws.append((tup, q, n_i, ridx, main_batch.submit(tup)))
    main_batch.flush_async().result()
    for tup, q, n_i, ridx, h in main_draws:
        o = h.labels
        ent = entity_fn(tup).astype(np.int64)
        ht = o / q / n_i
        np.add.at(counts, ent, ht)
        for j in range(200):
            np.add.at(boot[j], ent[ridx[j]], ht[ridx[j]])
    order = np.argsort(counts)[::-1]
    top = order[:k_top]
    # simultaneous percentile CIs: bootstrap of the sampled contribution plus
    # the (exact, constant) blocked contribution; Bonferroni over n_entities.
    a = (1.0 - query.confidence) / max(n_entities, 1)
    boot_total = boot + blocked_counts[None, :]
    ci_lo = np.quantile(boot_total, a / 2, axis=0)
    ci_hi = np.quantile(boot_total, 1 - a / 2, axis=0)
    return {
        "top": top,
        "counts": counts,
        "ci_lo": ci_lo,
        "ci_hi": ci_hi,
        "oracle_calls": query.oracle.calls,
        "oracle": query.oracle.stats(),
        "beta": beta,
    }
