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
import torch

from ..kernels.bootstrap_t import resample_moments
from ..kernels.plain import MOMENT_COUNT, MOMENT_CROSS, MOMENT_SUM
from ..obs.telemetry import count
from .estimators import BlockedRegime, StratumSample, combined_avg, combined_count, combined_sum
from .types import Agg, ConfidenceInterval


def _resample_matrix(rng: np.random.Generator, n_boot: int, n: int) -> np.ndarray:
    return rng.integers(0, n, size=(n_boot, n))


def _moments_host(st_c, ct_c, n_boot, rng) -> tuple:
    """Per-resample (mean shift, variance) of the SUM and COUNT terms and
    their covariance, summed over the strata: the reference's numpy code."""
    sum_shift = np.zeros(n_boot)
    cnt_shift = np.zeros(n_boot)
    var_sum = np.zeros(n_boot)
    var_cnt = np.zeros(n_boot)
    cov_sc = np.zeros(n_boot)
    for stc, ctc in zip(st_c, ct_c):
        n = len(stc)
        ridx = _resample_matrix(rng, n_boot, n)
        rs = stc[ridx]
        rc = ctc[ridx]
        ms = rs.mean(axis=1)
        mc = rc.mean(axis=1)
        sum_shift += ms
        cnt_shift += mc
        vs = rs.var(axis=1, ddof=1) / n
        vc = rc.var(axis=1, ddof=1) / n
        var_sum += vs
        var_cnt += vc
        cov_sc += ((rs - ms[:, None]) * (rc - mc[:, None])).sum(axis=1) / (
            (n - 1) * n
        )
    return sum_shift, cnt_shift, var_sum, var_cnt, cov_sc


def _moments_card(st_c, ct_c, agg, n_boot, rng, device) -> tuple:
    """The same moments from the same draws, made and reduced on the card
    (K8), only those ``agg`` reads (the others are 0)."""
    flags = {Agg.SUM: MOMENT_SUM, Agg.COUNT: MOMENT_COUNT,
             Agg.AVG: MOMENT_SUM | MOMENT_COUNT | MOMENT_CROSS}[agg]
    out, n_rej = resample_moments(st_c if flags & MOMENT_SUM else None,
                                  ct_c if flags & MOMENT_COUNT else None,
                                  n_boot, rng, flags, device)
    count("ci.rejections", n_rej)
    return tuple(out)


def bootstrap_t_ci(
    samples: list[StratumSample],
    blocked: BlockedRegime,
    agg: Agg,
    p: float,
    n_boot: int,
    rng: np.random.Generator,
    device="cpu",
) -> tuple[float, ConfidenceInterval]:
    """Returns (point estimate, bootstrap-t CI).  ``device`` is where the
    query runs: on a CUDA device the resamples are drawn and reduced on the
    card, from the same Generator draws (the CI agrees with the CPU's to
    f64 rounding); elsewhere in numpy."""
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

    # stratum-centred SUM / COUNT terms, resampled within each stratum
    base_sum = blocked.sum
    base_cnt = blocked.count
    st_c, ct_c = [], []
    for s in usable:
        st = s.sum_terms()
        ct = s.count_terms()
        base_sum += float(st.mean())
        base_cnt += float(ct.mean())
        st_c.append(st - st.mean())
        ct_c.append(ct - ct.mean())
    draws = n_boot * sum(s.n for s in usable)
    if torch.device(device).type == "cuda":
        moments = _moments_card(st_c, ct_c, agg, n_boot, rng, device)
        count("ci.draws_device", draws)
    else:
        moments = _moments_host(st_c, ct_c, n_boot, rng)
        count("ci.draws_host", draws)
    for s in samples:
        if s.n == 1:  # single-sample strata: add their point mass, no variance
            base_sum += float(s.sum_terms().mean())
            base_cnt += float(s.count_terms().mean())
    return est, _interval(agg, est, sigma, p, base_sum, base_cnt, *moments)


def _interval(agg, est, sigma, p, base_sum, base_cnt, sum_shift, cnt_shift, var_sum,
              var_cnt, cov_sc) -> ConfidenceInterval:
    """The studentised t of every resample and the CI from its quantiles."""
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
        return ConfidenceInterval(est - 10 * sigma, est + 10 * sigma, p)
    lo_q, hi_q = (1.0 - p) / 2.0, 1.0 - (1.0 - p) / 2.0
    t_lo = float(np.quantile(t, lo_q))
    t_hi = float(np.quantile(t, hi_q))
    return ConfidenceInterval(est - t_hi * sigma, est - t_lo * sigma, p)
