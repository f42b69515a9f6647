"""Bootstrap-t confidence intervals (paper §5.3 "CI via Resampling", App. B.1).

The merged pilot+main sample is not i.i.d. across strata, so CLT CIs are
invalid; bootstrap-t resampling *within each stratum* (the sampling design)
estimates the distribution of the studentised statistic

    t_j = (AGG_j-hat - AGG-hat) / sigma_j-hat

and uses its empirical percentiles:  CI = [mu - t_hi * s, mu - t_lo * s].
Blocked strata are constants and contribute no resampling variance.

Numerics: HT terms can be O(1e8); per-stratum terms are centred before
resampling (the t statistic is shift-invariant per stratum), which keeps the
reductions well-conditioned.
"""
from __future__ import annotations

import numpy as np

from .estimators import BlockedRegime, StratumSample, combined_avg, combined_count, combined_sum
from .types import Agg, ConfidenceInterval


def _resample_matrix(rng: np.random.Generator, n_boot: int, n: int) -> np.ndarray:
    return rng.integers(0, n, size=(n_boot, n))


def bootstrap_t_ci(
    samples: list[StratumSample],
    blocked: BlockedRegime,
    agg: Agg,
    p: float,
    n_boot: int,
    rng: np.random.Generator,
) -> tuple[float, ConfidenceInterval]:
    """Returns (point estimate, bootstrap-t CI)."""
    if agg is Agg.SUM:
        est, var = combined_sum(samples, blocked)
    elif agg is Agg.COUNT:
        est, var = combined_count(samples, blocked)
    elif agg is Agg.AVG:
        est, var = combined_avg(samples, blocked)
    else:
        raise ValueError(f"bootstrap-t only defined for linear aggs, got {agg}")
    sigma = float(np.sqrt(max(var, 0.0)))

    usable = [s for s in samples if s.n > 1]
    if not usable or sigma == 0.0:
        return est, ConfidenceInterval(est, est, p)

    # Per-resample per-stratum (mean shift, variance) for SUM / COUNT terms.
    sum_shift = np.zeros(n_boot)
    cnt_shift = np.zeros(n_boot)
    var_sum = np.zeros(n_boot)
    var_cnt = np.zeros(n_boot)
    cov_sc = np.zeros(n_boot)
    base_sum = blocked.sum
    base_cnt = blocked.count
    for s in usable:
        st = s.sum_terms()
        ct = s.count_terms()
        base_sum += float(st.mean())
        base_cnt += float(ct.mean())
        stc = st - st.mean()
        ctc = ct - ct.mean()
        ridx = _resample_matrix(rng, n_boot, s.n)
        rs = stc[ridx]
        rc = ctc[ridx]
        ms = rs.mean(axis=1)
        mc = rc.mean(axis=1)
        sum_shift += ms
        cnt_shift += mc
        vs = rs.var(axis=1, ddof=1) / s.n
        vc = rc.var(axis=1, ddof=1) / s.n
        var_sum += vs
        var_cnt += vc
        cov_sc += ((rs - ms[:, None]) * (rc - mc[:, None])).sum(axis=1) / (
            (s.n - 1) * s.n
        )
    for s in samples:
        if s.n == 1:  # single-sample strata: add their point mass, no variance
            base_sum += float(s.sum_terms().mean())
            base_cnt += float(s.count_terms().mean())

    if agg is Agg.SUM:
        est_j = base_sum + sum_shift
        sig_j = np.sqrt(np.maximum(var_sum, 0.0))
        base = base_sum
    elif agg is Agg.COUNT:
        est_j = base_cnt + cnt_shift
        sig_j = np.sqrt(np.maximum(var_cnt, 0.0))
        base = base_cnt
    else:  # AVG ratio per resample + delta-method sigma per resample
        sum_j = base_sum + sum_shift
        cnt_j = base_cnt + cnt_shift
        cnt_j = np.where(np.abs(cnt_j) < 1e-12, np.nan, cnt_j)
        est_j = sum_j / cnt_j
        base = base_sum / base_cnt if base_cnt != 0 else np.nan
        with np.errstate(invalid="ignore", divide="ignore"):
            sig_j = np.abs(est_j) * np.sqrt(
                np.maximum(
                    var_sum / sum_j**2 + var_cnt / cnt_j**2 - 2 * cov_sc / (sum_j * cnt_j),
                    0.0,
                )
            )

    with np.errstate(invalid="ignore", divide="ignore"):
        t = (est_j - base) / sig_j
    t = t[np.isfinite(t)]
    if len(t) < 10:
        return est, ConfidenceInterval(est - 10 * sigma, est + 10 * sigma, p)
    lo_q, hi_q = (1.0 - p) / 2.0, 1.0 - (1.0 - p) / 2.0
    t_lo = float(np.quantile(t, lo_q))
    t_hi = float(np.quantile(t, hi_q))
    ci = ConfidenceInterval(est - t_hi * sigma, est - t_lo * sigma, p)
    return est, ci
