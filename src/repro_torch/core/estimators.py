"""Combined blocking+sampling estimators (paper §5.2 Eq. 1-3, §5.3 extensions).

A *stratum sample* carries, per sampled tuple: the Oracle label ``o``, the
aggregated value ``g`` and the (within-stratum, exact) sampling probability
``q``.  Horvitz-Thompson per-stratum totals::

    SUM_i-hat   = mean(g * o / q)
    COUNT_i-hat = mean(o / q)

are unbiased for the stratum totals; blocked strata contribute exact totals.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StratumSample:
    o: np.ndarray          # (n,) oracle labels in {0,1}
    g: np.ndarray          # (n,) attribute values
    q: np.ndarray          # (n,) within-stratum sampling probabilities
    size: int              # |D_i|

    def __post_init__(self):
        self.o = np.asarray(self.o, np.float64)
        self.g = np.asarray(self.g, np.float64)
        self.q = np.asarray(self.q, np.float64)

    @property
    def n(self) -> int:
        return len(self.o)

    def sum_terms(self) -> np.ndarray:
        return self.g * self.o / self.q

    def count_terms(self) -> np.ndarray:
        return self.o / self.q

    def merge(self, other: "StratumSample") -> "StratumSample":
        assert self.size == other.size
        return StratumSample(
            o=np.concatenate([self.o, other.o]),
            g=np.concatenate([self.g, other.g]),
            q=np.concatenate([self.q, other.q]),
            size=self.size,
        )


@dataclasses.dataclass
class BlockedRegime:
    o: np.ndarray
    g: np.ndarray

    @property
    def count(self) -> float:
        return float(np.sum(self.o))

    @property
    def sum(self) -> float:
        return float(np.sum(self.g * self.o))


def _mean_var(x: np.ndarray) -> tuple[float, float]:
    m = float(np.mean(x)) if len(x) else 0.0
    v = float(np.var(x, ddof=1)) if len(x) > 1 else 0.0
    return m, v


def combined_sum(
    samples: list[StratumSample], blocked: BlockedRegime
) -> tuple[float, float]:
    """SUM-hat = SUM_b + sum_i mean(sum_terms_i); returns (estimate, var)."""
    est = blocked.sum
    var = 0.0
    for s in samples:
        m, v = _mean_var(s.sum_terms())
        est += m
        var += v / max(s.n, 1)
    return est, var


def combined_count(
    samples: list[StratumSample], blocked: BlockedRegime
) -> tuple[float, float]:
    est = blocked.count
    var = 0.0
    for s in samples:
        m, v = _mean_var(s.count_terms())
        est += m
        var += v / max(s.n, 1)
    return est, var


def combined_avg(
    samples: list[StratumSample],
    blocked: BlockedRegime,
    bias_correction: bool = True,
) -> tuple[float, float]:
    """Ratio estimator (Eq. 2) with Taylor bias correction (Eq. 3).

    Returns (estimate, var) where var is the delta-method variance of the
    ratio (paper §5.3 "Handling AVG").
    """
    s_hat, s_var = combined_sum(samples, blocked)
    c_hat, c_var = combined_count(samples, blocked)
    if c_hat <= 0:
        return 0.0, float("inf")
    avg = s_hat / c_hat
    if bias_correction and c_hat > 0:
        # Eq. (3): relative bias ~= Var[COUNT-hat] / COUNT-hat^2 (estimator
        # variance, already O(1/n)); clip to keep the correction sane when the
        # pilot variance estimate is noisy.
        corr = 1.0 - min(max(c_var / (c_hat**2), -0.5), 0.5)
        avg = avg * corr
    # delta-method variance; the cross-covariance term is computed from the
    # paired per-stratum terms (SUM and COUNT share samples).
    cov = 0.0
    for s in samples:
        st = s.sum_terms()
        ct = s.count_terms()
        if s.n > 1:
            cov += float(np.cov(st, ct, ddof=1)[0, 1]) / s.n
    var = (avg**2) * (
        s_var / max(s_hat**2, 1e-300)
        + c_var / max(c_hat**2, 1e-300)
        - 2.0 * cov / max(s_hat * c_hat, 1e-300)
    )
    return float(avg), float(max(var, 0.0))


def combined_extreme(
    samples: list[StratumSample], blocked: BlockedRegime, mode: str
) -> float:
    """MAX/MIN-hat = extreme over all *observed* matching values (paper §5.3)."""
    vals = []
    bm = blocked.o > 0
    if bm.any():
        vals.append(blocked.g[bm])
    for s in samples:
        m = s.o > 0
        if m.any():
            vals.append(s.g[m])
    if not vals:
        return float("nan")
    allv = np.concatenate(vals)
    return float(allv.max() if mode == "max" else allv.min())


def combined_cdf_median(
    samples: list[StratumSample], blocked: BlockedRegime
) -> float:
    """MEDIAN via the combined weighted CDF (paper §5.3 "Handling MEDIAN").

    Each blocked matching tuple contributes weight 1; each sampled matching
    tuple contributes its HT weight 1 / (n_i * q) — the estimated number of
    tuples it represents.
    """
    vals, wts = [], []
    bm = blocked.o > 0
    if bm.any():
        vals.append(blocked.g[bm])
        wts.append(np.ones(int(bm.sum()), np.float64))
    for s in samples:
        m = s.o > 0
        if m.any():
            vals.append(s.g[m])
            wts.append(1.0 / (s.n * s.q[m]))
    if not vals:
        return float("nan")
    v = np.concatenate(vals)
    w = np.concatenate(wts)
    order = np.argsort(v)
    v, w = v[order], w[order]
    c = np.cumsum(w)
    total = c[-1]
    pos = int(np.searchsorted(c, 0.5 * total))
    return float(v[min(pos, len(v) - 1)])


def weighted_quantile(
    values: np.ndarray, weights: np.ndarray, qs: np.ndarray
) -> np.ndarray:
    order = np.argsort(values)
    v, w = np.asarray(values)[order], np.asarray(weights)[order]
    c = np.cumsum(w)
    total = c[-1] if len(c) else 1.0
    out = []
    for q in np.atleast_1d(qs):
        pos = int(np.searchsorted(c, q * total))
        out.append(float(v[min(pos, len(v) - 1)]) if len(v) else float("nan"))
    return np.array(out)
