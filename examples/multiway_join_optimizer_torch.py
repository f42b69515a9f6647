"""Paper §7.4 — join-order optimisation with approximate COUNT on the
PyTorch + CUDA port: BAS cardinality estimates feed DPccp (interval DP on
chain joins) and pick a cheaper execution order than uniform-sampling
estimates.  The workload of ``examples/multiway_join_optimizer.py``, run
through ``repro_torch``; each sub-join's query runs on ``--device``:

    PYTHONPATH=src python examples/multiway_join_optimizer_torch.py               # a CUDA card
    PYTHONPATH=src python examples/multiway_join_optimizer_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import (
    bas_cardinality_provider,
    dp_chain_plan,
    plan_cost_under_truth,
    uniform_cardinality_provider,
)
from repro_torch.core.oracle import PairChainOracle
from repro_torch.data import make_chain_dataset


def true_card_fn(ds):
    def card(lo, hi):
        prod = None
        for e in range(lo, hi):
            m = ds.edge_truth[e].astype(np.float64)
            prod = m if prod is None else prod @ m
        return float(prod.sum()) if prod is not None else 0.0

    return card


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    # 4-way chain with skewed edge densities (Ecomm-Q11 style)
    ds = make_chain_dataset([80, 12, 70, 15], d=24, n_entities=10, noise=0.35, seed=9)
    sizes = [e.shape[0] for e in ds.embeddings]
    tc = true_card_fn(ds)
    print(f"4-way chain join; true sub-join cardinalities (device {args.device}):")
    for lo in range(4):
        for hi in range(lo + 1, 4):
            print(f"  |T{lo}..T{hi}| = {tc(lo, hi):.0f}")

    def oracle_factory(lo, hi):
        return PairChainOracle(ds.edge_truth[lo:hi])

    for name, provider in (
        ("BAS", bas_cardinality_provider(ds.spec(), oracle_factory, 800, seed=0,
                                         device=args.device)),
        ("UNIFORM", uniform_cardinality_provider(ds.spec(), oracle_factory, 800, seed=0,
                                                 device=args.device)),
        ("TRUE", tc),
    ):
        plan = dp_chain_plan(4, sizes, provider)
        cost = plan_cost_under_truth(plan, sizes, tc)
        print(f"\n{name:8s} plan: {plan.order_str()}")
        print(f"         true execution cost (Oracle probes): {cost:,.0f}")


if __name__ == "__main__":
    main()
