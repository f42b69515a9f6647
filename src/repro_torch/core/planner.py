"""Join-order optimisation from approximate COUNT estimates (paper §7.4).

For a k-table chain join the cross-product-free plan space is exactly the set
of contiguous-interval parenthesisations, so DPccp [60] reduces to interval
DP.  Cost model (paper's setting): executing a join of intermediates of
cardinalities |L| and |R| costs |L| * |R| Oracle probes; intermediate
cardinalities come from a cardinality provider — BAS COUNT with a small
budget, UNIFORM COUNT, WWJ COUNT, or the ground truth (for regret reporting).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


from .types import Agg, BASConfig, JoinSpec, Query
from .oracle import Oracle


@dataclasses.dataclass
class Plan:
    """Binary join tree over tables [i..j]."""
    lo: int
    hi: int
    left: Optional["Plan"] = None
    right: Optional["Plan"] = None
    cost: float = 0.0

    def order_str(self) -> str:
        if self.left is None:
            return f"T{self.lo}"
        return f"({self.left.order_str()} ⋈ {self.right.order_str()})"


CardFn = Callable[[int, int], float]  # (lo, hi) inclusive -> |join(T_lo..T_hi)|


def dp_chain_plan(k: int, sizes: list[int], card: CardFn) -> Plan:
    """Interval DP (DPccp on a chain).  cost(plan) = sum over internal joins of
    |left| * |right| (the Oracle probes to form the join)."""
    best: dict[tuple, Plan] = {}
    for i in range(k):
        best[(i, i)] = Plan(i, i, cost=0.0)

    def cardinality(lo, hi):
        return float(sizes[lo]) if lo == hi else max(float(card(lo, hi)), 1.0)

    for span in range(1, k):
        for lo in range(0, k - span):
            hi = lo + span
            best_plan = None
            for mid in range(lo, hi):
                l, r = best[(lo, mid)], best[(mid + 1, hi)]
                cost = l.cost + r.cost + cardinality(lo, mid) * cardinality(mid + 1, hi)
                if best_plan is None or cost < best_plan.cost:
                    best_plan = Plan(lo, hi, l, r, cost)
            best[(lo, hi)] = best_plan
    return best[(0, k - 1)]


def plan_cost_under_truth(plan: Plan, sizes: list[int], true_card: CardFn) -> float:
    """Re-cost a plan under ground-truth cardinalities (regret evaluation)."""
    if plan.left is None:
        return 0.0

    def cardinality(lo, hi):
        return float(sizes[lo]) if lo == hi else max(float(true_card(lo, hi)), 1.0)

    return (
        plan_cost_under_truth(plan.left, sizes, true_card)
        + plan_cost_under_truth(plan.right, sizes, true_card)
        + cardinality(plan.left.lo, plan.left.hi)
        * cardinality(plan.right.lo, plan.right.hi)
    )


def bas_cardinality_provider(
    spec: JoinSpec,
    oracle_factory: Callable[[int, int], Oracle],
    budget_per_subjoin: int,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    device="cuda",
) -> CardFn:
    """Cardinality of each contiguous sub-join via a BAS COUNT query.

    ``oracle_factory(lo, hi)`` must return an Oracle labelling tuples of
    tables lo..hi (inclusive).  Each sub-join's query runs on ``device``.
    """
    from .bas import run_bas

    cfg = cfg or BASConfig()
    cache: dict[tuple, float] = {}

    def card(lo: int, hi: int) -> float:
        key = (lo, hi)
        if key not in cache:
            sub = JoinSpec(embeddings=list(spec.embeddings[lo : hi + 1]))
            q = Query(
                spec=sub, agg=Agg.COUNT, oracle=oracle_factory(lo, hi),
                budget=budget_per_subjoin, confidence=0.95,
            )
            res = run_bas(q, cfg, seed=seed + lo * 31 + hi, device=device)
            cache[key] = max(res.estimate, 0.0)
        return cache[key]

    return card


def uniform_cardinality_provider(
    spec: JoinSpec,
    oracle_factory: Callable[[int, int], Oracle],
    budget_per_subjoin: int,
    seed: int = 0,
    device="cuda",
) -> CardFn:
    """Cardinality of each contiguous sub-join via a UNIFORM COUNT query
    (``device`` is passed on to :func:`~repro_torch.core.baselines.run_uniform`)."""
    from .baselines import run_uniform

    cache: dict[tuple, float] = {}

    def card(lo: int, hi: int) -> float:
        key = (lo, hi)
        if key not in cache:
            sub = JoinSpec(embeddings=list(spec.embeddings[lo : hi + 1]))
            q = Query(
                spec=sub, agg=Agg.COUNT, oracle=oracle_factory(lo, hi),
                budget=budget_per_subjoin, confidence=0.95,
            )
            res = run_uniform(q, seed=seed + lo * 31 + hi, device=device)
            cache[key] = max(res.estimate, 0.0)
        return cache[key]

    return card
