"""Blocking-augmented Sampling — the paper's main contribution (§5.2-5.3, Alg. 4).

Pipeline (dense path; the streaming path swaps stage 1 for the histogram
stratifier, see ``stratify.py``):

1. *Stratify*: top alpha*b pairs by weight -> K equal strata D_1..D_K
   (max blocking regime); everything else is D_0 (min sampling regime).
2. *Pilot* (budget b1): WWJ-sample every stratum ∝ weight, estimate
   per-stratum sampling variance of the agg-linearised HT terms.
3. *Allocate*: beta* = argmin estimated MSE (allocate.py).
4. *Execute* (budget b2): Oracle everything in blocked strata; WWJ-sample the
   rest with BudgetAssign sizes; merge with pilot samples (same within-stratum
   distribution -> poolable); optional top-up rounds spend budget freed by the
   Oracle cache.
5. *Estimate + CI*: combined estimators (estimators.py) and bootstrap-t
   (bootstrap.py).

Stages 2-5 are shared with the streaming path: :func:`run_stratified_pipeline`
takes a :class:`StratifiedSpace` (per-stratum sizes, weight masses and two
callbacks — sample a stratum, enumerate a blocked stratum's tuples) and runs
pilot / allocation / execution / estimation identically for both regimes.
``run_bas`` here wires the dense closures (materialised flat weights);
``bas_streaming.run_bas_streaming`` wires the walk+rejection / gathered-pair
closures.  Dispatch between the two is memory-aware: ``dispatch.run_auto``
routes to this dense path only when the (N1*...*Nk,) float64 flat weight
array fits under ``BASConfig.max_dense_weight_bytes``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..device import resolve_device
from ..obs.telemetry import span, traced_query
from . import allocate as alloc_mod
from .bootstrap import bootstrap_t_ci
from .estimators import (
    BlockedRegime,
    StratumSample,
    combined_cdf_median,
    combined_count,
    combined_extreme,
    combined_sum,
)
from .oracle import OracleBatch
from .similarity import chain_weights, flat_to_tuples
from .stratify import Stratification, stratify_dense
from .types import Agg, BASConfig, ConfidenceInterval, Query, QueryResult
from .wander import flat_sample


@dataclasses.dataclass
class StratumDraw:
    """A within-stratum sample *before* labelling: the pipeline coalesces all
    draws of a stage into one :class:`~repro_torch.core.oracle.OracleBatch` flush,
    so sampling closures never talk to the Oracle themselves."""

    tup: np.ndarray    # (n, k) tuple indices
    q: np.ndarray      # (n,) exact within-stratum sampling probabilities
    size: int          # |D_i|


def _draw_stratum(
    weights: np.ndarray,
    flat_idx: np.ndarray,
    n: int,
    query: Query,
    rng: np.random.Generator,
    defensive_mix: float = 0.0,
) -> StratumDraw:
    """WWJ within-stratum sampling: prob ∝ weight (plus a defensive uniform
    component), HT prob = exact normalised q."""
    w = weights[flat_idx]
    pos, q = flat_sample(w, n, rng, defensive_mix)
    chosen = flat_idx[pos]
    tup = flat_to_tuples(chosen, query.spec.sizes)
    return StratumDraw(tup=tup, q=q, size=len(flat_idx))


def _label_draws(
    query: Query, draws: list
) -> list:
    """Materialise StratumSamples from draws with ONE coalesced Oracle batch
    (dedup across strata/stages, single ledger charge, single backend call).

    Submit-then-await: the flush is submitted, the cheap g(.) evaluation
    follows, and the await surfaces any flush failure."""
    batch = OracleBatch(query.oracle)
    handles = [None if d is None else batch.submit(d.tup) for d in draws]
    fut = batch.flush_async()
    g = query.attr()
    gs = [None if d is None else g(d.tup) for d in draws]
    fut.result()
    return [
        None if d is None else StratumSample(
            o=h.labels, g=gv, q=d.q, size=d.size
        )
        for d, h, gv in zip(draws, handles, gs)
    ]


def _linearised_variance(s: StratumSample, agg: Agg, ratio: float, count_hat: float) -> float:
    """Pilot variance of the agg-appropriate linearised HT terms."""
    if agg is Agg.COUNT:
        t = s.count_terms()
    elif agg in (Agg.SUM, Agg.MEDIAN, Agg.MIN, Agg.MAX):
        t = s.sum_terms()
    else:  # AVG: influence function (s_t - R*c_t) / C
        c = max(count_hat, 1e-12)
        t = (s.sum_terms() - ratio * s.count_terms()) / c
    return float(np.var(t, ddof=1)) if len(t) > 1 else 0.0


def _stratum_flat_indices(strat: Stratification, weights: np.ndarray):
    """Returns list of per-stratum flat index arrays for strata 0..K.
    D_0 is represented lazily as a boolean complement mask for memory."""
    per = [None]  # D_0 handled via mask
    for i in range(1, strat.num_strata + 1):
        per.append(strat.stratum_indices(i))
    return per


def run_exact(query: Query) -> QueryResult:
    """Label everything (only valid when budget >= |D|)."""
    query.oracle.bind_sizes(query.spec.sizes)
    n = query.spec.n_tuples
    tup = flat_to_tuples(np.arange(n), query.spec.sizes)
    o = query.oracle.label(tup)
    g = query.attr()(tup)
    blocked = BlockedRegime(o=o, g=g)
    if query.agg is Agg.COUNT:
        est = blocked.count
    elif query.agg is Agg.SUM:
        est = blocked.sum
    elif query.agg is Agg.AVG:
        est = blocked.sum / max(blocked.count, 1e-12)
    elif query.agg in (Agg.MIN, Agg.MAX):
        est = combined_extreme([], blocked, query.agg.value)
    else:
        est = combined_cdf_median([], blocked)
    return QueryResult(
        estimate=float(est),
        ci=ConfidenceInterval(float(est), float(est), query.confidence),
        oracle_calls=query.oracle.calls,
        detail={"mode": "exact", "oracle": query.oracle.stats()},
    )


# ----------------------------------------------------------------------------
# Shared stages 2-5: pilot -> allocate -> execute -> estimate/CI.
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class StratifiedSpace:
    """Everything the estimator assembly needs to know about a stratified
    join space, independent of whether the cross product is materialised.

    ``sample_stratum(i, n)`` draws n tuples from stratum i with exact
    within-stratum probabilities and returns a :class:`StratumDraw` — no
    labels: the pipeline batches all labelling through the Oracle's batch
    API.  ``stratum_tuples(i)`` enumerates stratum i's (n_i, k) tuple indices
    for blocking (only ever called for i >= 1 — D_0 cannot be blocked).
    ``meta`` records how the space was stratified (e.g. the single-sweep
    pass/rescan stats) and is surfaced in ``QueryResult.detail``."""

    sizes: np.ndarray          # (K+1,) |D_0..D_K|
    weight_sums: np.ndarray    # (K+1,) total sampling weight per stratum
    sample_stratum: Callable[[int, int], StratumDraw]
    stratum_tuples: Callable[[int], np.ndarray]
    meta: dict = dataclasses.field(default_factory=dict)


def run_stratified_pipeline(
    query: Query,
    cfg: BASConfig,
    rng: np.random.Generator,
    space: StratifiedSpace,
    detail: dict,
    device="cuda",
) -> QueryResult:
    """Alg. 4 lines 6-17 on an abstract stratified space (shared by the dense
    and streaming BAS paths).  Each stage is a span of the active query;
    the bootstrap-t runs where the query runs (``device``)."""
    sizes, weight_sums = space.sizes, space.weight_sums
    k = len(sizes) - 1
    b = query.budget
    b1 = max(int(round(cfg.pilot_fraction * b)), 8)

    # ---- stage 1: pilot ---------------------------------------------------
    with span("joinml.pilot"):
        shares = weight_sums / max(weight_sums.sum(), 1e-300)
        n_pilot = np.maximum((shares * b1).astype(np.int64), 2)
        while n_pilot.sum() > b1 and n_pilot.max() > 2:
            n_pilot[np.argmax(n_pilot)] -= 1

        pilot_draws: list[Optional[StratumDraw]] = [None] * (k + 1)
        for i in range(k + 1):
            if sizes[i] > 0:
                pilot_draws[i] = space.sample_stratum(i, int(n_pilot[i]))
        samples: list[Optional[StratumSample]] = _label_draws(query, pilot_draws)

        live = [s for s in samples if s is not None]
        c_hat, _ = combined_count(live, BlockedRegime(np.zeros(0), np.zeros(0)))
        s_hat, _ = combined_sum(live, BlockedRegime(np.zeros(0), np.zeros(0)))
        ratio = s_hat / c_hat if c_hat > 0 else 0.0
        sigma2 = np.zeros(k + 1, np.float64)
        for i in range(k + 1):
            if samples[i] is not None:
                sigma2[i] = _linearised_variance(samples[i], query.agg, ratio, c_hat)

    # ---- allocation -------------------------------------------------------
    with span("joinml.allocate"):
        b2_eff = query.budget - query.oracle.calls
        if query.agg in (Agg.MIN, Agg.MAX):
            allocation = _allocate_extreme(samples, sizes, weight_sums, b2_eff, query.agg)
        else:
            allocation = alloc_mod.argmin_beta(
                sigma2, weight_sums, sizes, b2_eff, cfg.exact_beta_max_k
            )
        beta = set(int(i) for i in allocation.beta)

    # ---- stage 2: blocking + sampling -------------------------------------
    with span("joinml.execute"):
        # submit-then-await: one flush labels the blocking regime, then g(.) is
        # evaluated for the same tuples
        block_batch = OracleBatch(query.oracle)
        beta_tuples = [(i, space.stratum_tuples(i)) for i in sorted(beta)]
        beta_handles = [block_batch.submit(tup) for _, tup in beta_tuples]
        block_fut = block_batch.flush_async()
        g_fn = query.attr()
        blocked_g = [g_fn(tup) for _, tup in beta_tuples]
        block_fut.result()
        blocked_o = [h.labels for h in beta_handles]
        blocked = BlockedRegime(
            o=np.concatenate(blocked_o) if blocked_o else np.zeros(0),
            g=np.concatenate(blocked_g) if blocked_g else np.zeros(0),
        )

        sampled_ids = [i for i in range(k + 1) if i not in beta and sizes[i] > 0]
        rounds = 0
        while rounds < 4:
            remaining = query.budget - query.oracle.calls
            if remaining < 2 * max(len(sampled_ids), 1):
                break
            w_s = np.array([weight_sums[i] for i in sampled_ids])
            share = w_s / max(w_s.sum(), 1e-300)
            n_main = np.maximum((share * remaining).astype(np.int64), 1)
            while n_main.sum() > remaining:
                n_main[np.argmax(n_main)] -= 1
            before = query.oracle.calls
            round_draws: list[Optional[StratumDraw]] = [None] * (k + 1)
            for j, i in enumerate(sampled_ids):
                if n_main[j] <= 0:
                    continue
                round_draws[i] = space.sample_stratum(i, int(n_main[j]))
            round_samples = _label_draws(query, round_draws)
            for i in sampled_ids:
                new = round_samples[i]
                if new is not None:
                    samples[i] = new if samples[i] is None else samples[i].merge(new)
            rounds += 1
            if query.oracle.calls == before:  # everything cached; budget cannot move
                break

    # ---- estimate + CI ----------------------------------------------------
    with span("joinml.ci"):
        live = [samples[i] for i in range(k + 1) if i not in beta and samples[i] is not None]
        if query.agg in (Agg.COUNT, Agg.SUM, Agg.AVG):
            est, ci = bootstrap_t_ci(
                live, blocked, query.agg, query.confidence, cfg.n_bootstrap, rng,
                device=device,
            )
        elif query.agg in (Agg.MIN, Agg.MAX):
            est = combined_extreme(live, blocked, query.agg.value)
            gb = query.g_bounds
            if query.agg is Agg.MAX:
                hi = gb[1] if gb else est
                ci = ConfidenceInterval(est, hi, query.confidence)
            else:
                lo = gb[0] if gb else est
                ci = ConfidenceInterval(lo, est, query.confidence)
        elif query.agg is Agg.MEDIAN:
            est = combined_cdf_median(live, blocked)
            ci = _bootstrap_median_ci(live, blocked, query.confidence, cfg.n_bootstrap, rng)
        else:
            raise ValueError(query.agg)

    return QueryResult(
        estimate=float(est),
        ci=ci,
        oracle_calls=query.oracle.calls,
        detail={
            **detail,
            **({"stratify": space.meta} if space.meta else {}),
            "beta": sorted(beta),
            "num_strata": k,
            "stratum_sizes": sizes.tolist(),
            "pilot_n": n_pilot.tolist(),
            "est_mse": allocation.est_mse,
            "oracle": query.oracle.stats(),
        },
    )


def build_dense_space(
    query: Query,
    cfg: BASConfig,
    rng: np.random.Generator,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> StratifiedSpace:
    """Stage 1 of the dense path: materialised chain weights + sorted-top
    stratification, packaged as a :class:`StratifiedSpace`.  Shared by
    ``run_bas`` and the cascade estimator (``cascade.run_bas_cascade``), so
    both regimes stratify identically and differ only in how the pipeline
    spends the Oracle budget."""
    # ---- similarity + stratification -------------------------------------
    with span("joinml.similarity"):
        if weights is None:
            weights = chain_weights(
                query.spec.embeddings, cfg.weight_exponent, cfg.weight_floor,
                device=device,
            )

    with span("joinml.stratify"):
        strat = stratify_dense(weights, cfg.alpha, query.budget, cfg)
        k = strat.num_strata
        sizes = strat.stratum_sizes()
        per_idx = _stratum_flat_indices(strat, weights)
        top_sum = float(weights[strat.order].sum())
        total_sum = float(weights.sum())
        weight_sums = np.empty(k + 1, np.float64)
        weight_sums[0] = max(total_sum - top_sum, 0.0)
        for i in range(1, k + 1):
            weight_sums[i] = float(weights[per_idx[i]].sum())
        # D_0 sampling weights: zero out the blocking regime
        w0 = np.array(weights, np.float64, copy=True)
        w0[strat.order] = 0.0

    def sample_stratum(i: int, n: int) -> StratumDraw:
        if i == 0:
            pos, q = flat_sample(w0, n, rng, cfg.defensive_mix)
            tup = flat_to_tuples(pos, query.spec.sizes)
            return StratumDraw(tup=tup, q=q, size=int(sizes[0]))
        return _draw_stratum(weights, per_idx[i], n, query, rng, cfg.defensive_mix)

    return StratifiedSpace(
        sizes=sizes,
        weight_sums=weight_sums,
        sample_stratum=sample_stratum,
        stratum_tuples=lambda i: flat_to_tuples(per_idx[i], query.spec.sizes),
        meta={"path": "dense-sort"},
    )


@traced_query
def run_bas(
    query: Query,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> QueryResult:
    """Dense BAS: materialised chain weights (a torch matmul on ``device``)
    and sorted-top stratification."""
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)

    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    n_total = query.spec.n_tuples
    if query.budget >= n_total:
        return run_exact(query)

    space = build_dense_space(query, cfg, rng, weights, device)
    return run_stratified_pipeline(query, cfg, rng, space, {"mode": "bas"}, device)


def _bootstrap_median_ci(samples, blocked, p, n_boot, rng):
    """Percentile bootstrap on the combined weighted-CDF median (paper notes
    MEDIAN is Hadamard differentiable so the bootstrap is valid)."""
    meds = []
    for _ in range(min(n_boot, 400)):
        rs = []
        for s in samples:
            ridx = rng.integers(0, s.n, size=s.n)
            rs.append(StratumSample(o=s.o[ridx], g=s.g[ridx], q=s.q[ridx], size=s.size))
        meds.append(combined_cdf_median(rs, blocked))
    meds = np.array([m for m in meds if np.isfinite(m)])
    if len(meds) < 10:
        m = combined_cdf_median(samples, blocked)
        return ConfidenceInterval(m, m, p)
    lo = float(np.quantile(meds, (1 - p) / 2))
    hi = float(np.quantile(meds, 1 - (1 - p) / 2))
    return ConfidenceInterval(lo, hi, p)


def _allocate_extreme(samples, sizes, weight_sums, b2, agg):
    """MIN/MAX allocation (paper §5.3): block the strata most likely to contain
    the extreme.  Exceedance score per stratum = exponential-tail estimate of
    P(value beyond current observed extreme) from pilot positives."""
    k = len(sizes) - 1
    sign = 1.0 if agg is Agg.MAX else -1.0
    observed = [
        sign * s.g[s.o > 0] for s in samples if s is not None and (s.o > 0).any()
    ]
    cur = max((float(v.max()) for v in observed), default=-np.inf)
    scores = np.zeros(k + 1)
    for i in range(1, k + 1):
        s = samples[i]
        if s is None:
            continue
        v = sign * s.g[s.o > 0]
        if len(v) == 0:
            continue
        mu = float(v.mean())
        scale = float(v.std(ddof=1)) if len(v) > 1 else abs(mu) + 1.0
        scale = max(scale, 1e-9)
        # exponential tail: P(X > cur) ~ exp(-(cur - mu)/scale)
        scores[i] = np.exp(-max(cur - mu, 0.0) / scale) * sizes[i]
    order = np.argsort(scores[1:])[::-1] + 1
    beta, cost = [], 0
    for i in order:
        if scores[i] <= 0:
            break
        if cost + sizes[i] <= b2 * 0.9:  # keep some budget for sampling
            beta.append(int(i))
            cost += int(sizes[i])
    mask = np.zeros(k + 1, bool)
    mask[beta] = True
    return alloc_mod.Allocation(
        beta=np.array(sorted(beta), np.int64),
        n_per_stratum=alloc_mod.budget_assign(b2, weight_sums, sizes, mask),
        est_mse=float("nan"),
    )
