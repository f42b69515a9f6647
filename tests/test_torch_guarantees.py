"""The port's copy of the statistical-coverage harness
(``tests/test_guarantees.py``): what the paper sells is the guarantee
``P(mu in CI) >= p`` at any oracle budget, so every estimator path of the
port — dense and streaming BAS, and the multi-fidelity cascade on both
regimes — runs 50 seeded replicates over the same small synthetic workload
with known ground truth, on the CPU, and their empirical coverage must stay
above ``nominal - slack`` with the reference's slack (0.10 under nominal
0.95: the binomial noise of 50 replicates plus small-sample bootstrap-t
error)."""
import numpy as np
import pytest

from repro_torch.core import (
    Agg,
    ArrayOracle,
    BASConfig,
    Query,
    run_bas,
    run_bas_cascade,
    run_bas_streaming,
)
from repro_torch.data import make_clustered_tables

N_REP = 50
NOMINAL = 0.95
SLACK = 0.10
BUDGET = 500
CFG = BASConfig(n_bootstrap=200)


@pytest.fixture(scope="module")
def workload():
    ds = make_clustered_tables(96, 96, n_entities=150, noise=0.45, seed=11)
    truth = float(ds.truth.sum())
    assert truth > 0
    return ds, truth


def _coverage(ds, truth, run_one, agg=Agg.COUNT, g=None):
    hits, ests = 0, []
    for seed in range(N_REP):
        q = Query(spec=ds.spec(), agg=agg, oracle=ds.oracle(), budget=BUDGET, g=g)
        res = run_one(q, seed)
        hits += res.ci.contains(truth)
        ests.append(res.estimate)
    return hits / N_REP, ests


PATHS = {
    "bas-dense": lambda q, s: run_bas(q, CFG, seed=s, device="cpu"),
    "bas-streaming": lambda q, s: run_bas_streaming(q, CFG, seed=s, device="cpu"),
    "cascade-dense": lambda q, s: run_bas_cascade(q, CFG, seed=s, path="dense",
                                                  device="cpu"),
    "cascade-streaming": lambda q, s: run_bas_cascade(q, CFG, seed=s,
                                                      path="streaming",
                                                      device="cpu"),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_count_ci_coverage_at_nominal(workload, path):
    ds, truth = workload
    cov, ests = _coverage(ds, truth, PATHS[path])
    assert cov >= NOMINAL - SLACK, (
        f"{path}: coverage {cov:.2f} < {NOMINAL - SLACK:.2f} "
        f"(mean est {np.mean(ests):.1f}, truth {truth:.1f})"
    )
    assert np.std(ests) > 0.0
    assert abs(np.mean(ests) - truth) < 0.25 * truth


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sum_ci_coverage_at_nominal(workload, path):
    ds, _ = workload
    col = ds.columns1["value"]
    g = lambda idx: col[idx[:, 0]]  # noqa: E731
    truth = float((col[:, None] * ds.truth).sum())
    cov, ests = _coverage(ds, truth, PATHS[path], agg=Agg.SUM, g=g)
    assert cov >= NOMINAL - SLACK, f"{path}: SUM coverage {cov:.2f}"
    assert abs(np.mean(ests) - truth) < 0.3 * truth


def test_cascade_coverage_robust_to_garbage_proxy(workload):
    """An adversarial proxy (labels = coin flips, uncorrelated with truth)
    widens the cascade's CIs but must not break their validity — the
    difference estimator corrects any proxy bias by construction."""
    ds, truth = workload
    rng = np.random.default_rng(99)
    garbage = ArrayOracle((rng.random(ds.truth.shape) < 0.5).astype(np.float64))
    hits = 0
    for seed in range(N_REP):
        q = Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(), budget=BUDGET,
                  proxy=garbage)
        res = run_bas_cascade(q, CFG, seed=seed, path="dense", device="cpu")
        hits += res.ci.contains(truth)
    assert hits / N_REP >= NOMINAL - SLACK
