"""Weighted Wander Join (paper §5.1, Alg. 3).

WWJ = Wander Join with an *approximate* index: every random-walk step samples
the next record with probability proportional to embedding similarity, and a
Horvitz-Thompson correction (importance sampling over the cross product)
keeps the estimator unbiased.

Two samplers:

* :func:`walk_sample` — the faithful per-step random walk for k tables.  Cost
  O(n * sum_i N_i), never touches the cross product (paper's complexity
  argument, §5.1).
* :func:`flat_sample` — categorical over an explicit weight vector; used for
  within-stratum sampling in BAS (Alg. 4 ``WeightedSample(D_i, n_i, W)``) on
  the dense path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve_device
from .similarity import as_f32_tensor, pair_weights_t
from .types import ConfidenceInterval


@dataclasses.dataclass
class WalkSample:
    idx: np.ndarray    # (n, k) tuple indices
    prob: np.ndarray   # (n,) sampling probability of each tuple (exact)


def _categorical_rows(w: np.ndarray, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Per-row categorical sample.  Returns (choice, prob_of_choice)."""
    totals = w.sum(axis=1, keepdims=True)
    cdf = np.cumsum(w, axis=1) / totals
    u = rng.random((w.shape[0], 1))
    choice = (cdf < u).sum(axis=1)
    choice = np.minimum(choice, w.shape[1] - 1)
    prob = np.take_along_axis(w, choice[:, None], axis=1)[:, 0] / totals[:, 0]
    return choice.astype(np.int64), prob


def walk_sample(
    embeddings: list[np.ndarray],
    n: int,
    rng: np.random.Generator,
    exponent: float = 1.0,
    floor: float = 1e-3,
    chunk: int = 4096,
    device="cuda",
) -> WalkSample:
    """n independent WWJ random walks over a k-table chain.

    Each step's (chunk, N) weight block is computed and sampled on the
    device (:func:`_categorical_rows_t`); only the chosen indices and their
    probabilities cross to the host.  The uniforms come from ``rng`` in the
    same order as the host sampler draws them."""
    dev = resolve_device(device)
    k = len(embeddings)
    n1 = embeddings[0].shape[0]
    idx = np.empty((n, k), np.int64)
    prob = np.full((n,), 1.0 / n1, np.float64)
    idx[:, 0] = rng.integers(0, n1, size=n)
    for step in range(k - 1):
        nxt_t = as_f32_tensor(embeddings[step + 1], dev)
        for s in range(0, n, chunk):
            cur = idx[s : s + chunk, step]
            w = pair_weights_t(
                as_f32_tensor(embeddings[step][cur], dev), nxt_t, exponent,
                floor,
            ).double()
            nxt, p = _categorical_rows_t(w, rng)
            idx[s : s + chunk, step + 1] = nxt
            prob[s : s + chunk] *= p
    return WalkSample(idx=idx, prob=prob)


def _categorical_rows_t(w, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """:func:`_categorical_rows` on a float64 tensor, on its device."""
    import torch

    totals = w.sum(dim=1, keepdim=True)
    cdf = torch.cumsum(w, dim=1) / totals
    u = torch.from_numpy(rng.random((w.shape[0], 1))).to(w.device)
    choice = (cdf < u).sum(dim=1)
    choice = torch.clamp(choice, max=w.shape[1] - 1)
    prob = torch.gather(w, 1, choice[:, None])[:, 0] / totals[:, 0]
    return choice.cpu().numpy().astype(np.int64), prob.cpu().numpy()


def flat_sample(
    weights: np.ndarray, n: int, rng: np.random.Generator,
    defensive_mix: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample n positions from ``weights`` (with replacement) with probability
    proportional to weight.  Returns (positions, normalised probabilities).

    ``defensive_mix`` in (0, 1) mixes a uniform component over the *support*
    (weight > 0) into the proposal — defensive importance sampling: the HT
    weight is then bounded by |support| / mix, trading a little efficiency on
    clean weights for bounded variance when the weights are misleading."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if total <= 0 or len(w) == 0:
        raise ValueError("cannot sample from empty/zero weights")
    p = w / total
    if defensive_mix > 0.0:
        support = (w > 0).astype(np.float64)
        p = (1.0 - defensive_mix) * p + defensive_mix * support / support.sum()
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    pos = np.searchsorted(cdf, rng.random(n), side="right")
    pos = np.minimum(pos, len(w) - 1)
    return pos.astype(np.int64), p[pos]


# ----------------------------------------------------------------------------
# Standalone WWJ estimator (Alg. 3): the paper's sampling-only method.
# ----------------------------------------------------------------------------

def ht_terms(values: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Horvitz-Thompson terms x_i = v_i / p_i; mean over them is unbiased for
    the population total when p is the exact sampling distribution."""
    return np.asarray(values, np.float64) / np.asarray(probs, np.float64)


def clt_ci(x: np.ndarray, p: float) -> tuple[float, ConfidenceInterval]:
    """Normal-approximation CI on the mean of HT terms (Alg. 3 lines 9-10)."""
    from scipy import stats

    x = np.asarray(x, np.float64)
    mu = float(x.mean())
    if len(x) < 2:
        return mu, ConfidenceInterval(-np.inf, np.inf, p)
    se = float(x.std(ddof=1) / np.sqrt(len(x)))
    z = float(stats.norm.ppf(0.5 + p / 2.0))
    return mu, ConfidenceInterval(mu - z * se, mu + z * se, p)
