"""Adaptive budget allocation (paper §5.3, Alg. 4 lines 6-11 + Appendix B.1).

Given pilot estimates sigma_i^2 of per-stratum sampling variance, find the
subset beta of strata {1..K} to *block* (Oracle everything) minimising the
estimated MSE of the combined estimator:

    MSE(beta) = sum_{i not in beta} sigma_i^2 / n_i(beta)
    n_i(beta) = (b2 - sum_{j in beta} |D_j|) * W_i / sum_{j not in beta} W_j

D_0 (the minimum sampling regime) can never be blocked.  The paper solves the
arg-min with unspecified "iterative methods"; we provide an exact vectorised
subset enumeration for K <= exact_max_k and a greedy + single-swap local
search beyond (tests cross-check the two on small K).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Allocation:
    beta: np.ndarray          # sorted int array of blocked strata in {1..K}
    n_per_stratum: np.ndarray  # (K+1,) budgets for strata 0..K (blocked: |D_i|)
    est_mse: float


def budget_assign(
    b2: int,
    weight_sums: np.ndarray,   # (K+1,) total weight of strata 0..K
    sizes: np.ndarray,         # (K+1,) sizes of strata 0..K
    beta_mask: np.ndarray,     # (K+1,) bool; beta_mask[0] must be False
) -> np.ndarray:
    """Alg. 4 BudgetAssign: remaining budget split ∝ stratum weight mass."""
    blocked_cost = sizes[beta_mask].sum()
    rem = max(float(b2) - float(blocked_cost), 0.0)
    w = np.where(beta_mask, 0.0, weight_sums.astype(np.float64))
    denom = w.sum()
    n = np.zeros_like(w)
    if denom > 0:
        n = rem * w / denom
    n[beta_mask] = sizes[beta_mask]
    return n


def estimate_mse(
    sigma2: np.ndarray, weight_sums: np.ndarray, sizes: np.ndarray,
    beta_mask: np.ndarray, b2: int,
) -> float:
    """Estimated MSE of the combined SUM estimator for allocation beta."""
    n = budget_assign(b2, weight_sums, sizes, beta_mask)
    sampled = ~beta_mask
    ni = n[sampled]
    if np.any(ni < 1.0):
        return float("inf")  # infeasible: a sampled stratum got no budget
    return float(np.sum(sigma2[sampled] / ni))


def _eval_many(sigma2, weight_sums, sizes, masks, b2):
    """Vectorised estimate_mse over (M, K+1) bool masks."""
    sizes = sizes.astype(np.float64)
    w = np.where(masks, 0.0, weight_sums[None, :].astype(np.float64))
    blocked_cost = (sizes[None, :] * masks).sum(axis=1)
    rem = np.maximum(float(b2) - blocked_cost, 0.0)
    denom = w.sum(axis=1)
    # n_i for sampled strata
    with np.errstate(divide="ignore", invalid="ignore"):
        n = rem[:, None] * w / np.where(denom[:, None] > 0, denom[:, None], 1.0)
        contrib = np.where(masks, 0.0, sigma2[None, :] / np.where(n > 0, n, np.nan))
    mse = contrib.sum(axis=1)
    infeasible = np.any((~masks) & (n < 1.0), axis=1) | (denom <= 0)
    mse = np.where(infeasible | np.isnan(mse), np.inf, mse)
    return mse


def argmin_beta(
    sigma2: np.ndarray,
    weight_sums: np.ndarray,
    sizes: np.ndarray,
    b2: int,
    exact_max_k: int = 16,
) -> Allocation:
    """Find beta minimising estimated MSE.  Inputs indexed 0..K (D_0 first)."""
    k = len(sigma2) - 1
    sigma2 = np.asarray(sigma2, np.float64)
    weight_sums = np.asarray(weight_sums, np.float64)
    sizes = np.asarray(sizes, np.int64)

    def mask_from_beta(beta_set):
        m = np.zeros(k + 1, dtype=bool)
        for i in beta_set:
            m[i] = True
        return m

    if k <= exact_max_k:
        n_sub = 1 << k
        subsets = np.arange(n_sub, dtype=np.uint32)
        masks = np.zeros((n_sub, k + 1), dtype=bool)
        for i in range(1, k + 1):
            masks[:, i] = (subsets >> (i - 1)) & 1
        # drop infeasible (blocked cost > b2)
        mse = _eval_many(sigma2, weight_sums, sizes, masks, b2)
        best = int(np.argmin(mse))
        beta = np.nonzero(masks[best][1:])[0] + 1
        return Allocation(
            beta=beta.astype(np.int64),
            n_per_stratum=budget_assign(b2, weight_sums, sizes, masks[best]),
            est_mse=float(mse[best]),
        )

    # Greedy forward selection + single-swap local search.
    current = set()
    cur_mask = mask_from_beta(current)
    cur_mse = estimate_mse(sigma2, weight_sums, sizes, cur_mask, b2)
    improved = True
    while improved:
        improved = False
        candidates = []
        for i in range(1, k + 1):
            if i not in current:
                candidates.append(current | {i})
        for i in list(current):
            candidates.append(current - {i})
            for j in range(1, k + 1):
                if j not in current:
                    candidates.append((current - {i}) | {j})
        if not candidates:
            break
        masks = np.stack([mask_from_beta(c) for c in candidates])
        mses = _eval_many(sigma2, weight_sums, sizes, masks, b2)
        best = int(np.argmin(mses))
        if mses[best] < cur_mse - 1e-12:
            current = set(np.nonzero(masks[best][1:])[0] + 1)
            cur_mse = float(mses[best])
            cur_mask = masks[best]
            improved = True
    return Allocation(
        beta=np.array(sorted(current), np.int64),
        n_per_stratum=budget_assign(b2, weight_sums, sizes, cur_mask),
        est_mse=float(cur_mse),
    )
