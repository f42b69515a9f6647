"""The port's host statistics are numpy copies of the reference's, so on the
same seeded inputs they must give the same numbers bit for bit: allocation,
the combined estimators, the bootstrap-t CI, the flat and per-row
categorical samplers, and the Oracle ledger with its batched flushes.

The card's bootstrap (K8) replays the Generator's resample draws: its plain
NumPy version (``kernels/plain.py``) is held here to ``Generator.integers``
draw for draw, state after included, and its moments to the numpy path's."""
import numpy as np
import pytest

from repro.core import allocate as r_alloc
from repro.core import bootstrap as r_boot
from repro.core import estimators as r_est
from repro.core import oracle as r_or
from repro.core import wander as r_wander
from repro.core.types import Agg as RAgg
from repro_torch.core import allocate, bootstrap, estimators, oracle, wander
from repro_torch.core.types import Agg
from repro_torch.kernels import plain
from repro_torch.kernels.bootstrap_t import resample_moments
from repro_torch.obs import telemetry


def _strata(mod, seed, k=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(3, 40))
        out.append(mod.StratumSample(
            o=(rng.random(n) < 0.4).astype(float), g=rng.lognormal(1.0, 0.7, n),
            q=rng.dirichlet(np.ones(n)) + 1e-6, size=int(rng.integers(n, 500))))
    blocked = mod.BlockedRegime(o=(rng.random(30) < 0.5).astype(float),
                                g=rng.lognormal(1.0, 0.7, 30))
    return out, blocked


@pytest.mark.parametrize("seed", range(4))
def test_allocation_bit_equal(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 20))
    sigma2 = rng.random(k + 1) * 10
    ws = rng.random(k + 1) * 100
    sizes = rng.integers(1, 3000, k + 1)
    for b2 in (50, 1000, 20000):
        a = allocate.argmin_beta(sigma2, ws, sizes, b2, exact_max_k=8)
        b = r_alloc.argmin_beta(sigma2, ws, sizes, b2, exact_max_k=8)
        np.testing.assert_array_equal(a.beta, b.beta)
        np.testing.assert_array_equal(a.n_per_stratum, b.n_per_stratum)
        assert a.est_mse == b.est_mse
        mask = np.zeros(k + 1, bool)
        mask[1::2] = True
        np.testing.assert_array_equal(allocate.budget_assign(b2, ws, sizes, mask),
                                      r_alloc.budget_assign(b2, ws, sizes, mask))


@pytest.mark.parametrize("seed", range(4))
def test_estimators_bit_equal(seed):
    mine, mb = _strata(estimators, seed)
    ref, rb = _strata(r_est, seed)
    assert estimators.combined_sum(mine, mb) == r_est.combined_sum(ref, rb)
    assert estimators.combined_count(mine, mb) == r_est.combined_count(ref, rb)
    assert estimators.combined_avg(mine, mb) == r_est.combined_avg(ref, rb)
    for mode in ("max", "min"):
        assert estimators.combined_extreme(mine, mb, mode) == \
            r_est.combined_extreme(ref, rb, mode)
    assert estimators.combined_cdf_median(mine, mb) == r_est.combined_cdf_median(ref, rb)
    merged = mine[0].merge(estimators.StratumSample(mine[0].o, mine[0].g, mine[0].q,
                                                    mine[0].size))
    np.testing.assert_array_equal(merged.sum_terms(),
                                  np.concatenate([mine[0].sum_terms()] * 2))


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG"])
@pytest.mark.parametrize("seed", range(3))
def test_bootstrap_bit_equal(agg, seed):
    mine, mb = _strata(estimators, seed)
    ref, rb = _strata(r_est, seed)
    a = bootstrap.bootstrap_t_ci(mine, mb, Agg[agg], 0.95, 300,
                                 np.random.default_rng(seed))
    b = r_boot.bootstrap_t_ci(ref, rb, RAgg[agg], 0.95, 300,
                              np.random.default_rng(seed))
    assert a[0] == b[0]
    assert (a[1].lo, a[1].hi, a[1].p) == (b[1].lo, b[1].hi, b[1].p)


def _generator(seed, buffered):
    """A PCG64 Generator, holding a half-word on entry where ``buffered``."""
    rng = np.random.default_rng(seed)
    if buffered:
        rng.integers(0, 10, 1)
    assert rng.bit_generator.state["has_uint32"] == int(buffered)
    return rng


@pytest.mark.parametrize("highs,n_boot,buffered", [
    ([5, 7, 1000], 4, True),           # a half-word buffered on entry
    ([2, 2, 3, 2], 101, False),        # strata of 2, an odd n_boot
    ([17, 1000, 2, 40], 999, True),    # several strata, an odd n_boot
])
def test_replayed_resamples_equal_generator(highs, n_boot, buffered):
    """The card's draw scheme gives each stratum's
    ``integers(0, n_i, size=(n_boot, n_i))`` in order, and the state
    after them."""
    rng = _generator(7, buffered)
    highs = np.array(highs)
    draws, after, _ = plain.replay_integers(rng.bit_generator.state, highs, n_boot * highs)
    for n, got in zip(highs, draws, strict=True):
        np.testing.assert_array_equal(got.reshape(n_boot, n),
                                      rng.integers(0, n, size=(n_boot, n)))
    assert after == rng.bit_generator.state


@pytest.mark.parametrize("buffered", [False, True])
def test_replay_resolves_rejections(buffered):
    """Ranges just over 2**31 and at 3e9 reject about half and a third of
    their words: thousands of rejections, runs of them at one draw, and
    strata boundaries crossed with a large word offset."""
    rng = _generator(8, buffered)
    highs, counts = [2**31 + 12_345, 3 * 10**9, 7], [2000, 2000, 5]
    draws, after, n_rej = plain.replay_integers(rng.bit_generator.state, highs, counts)
    assert n_rej > 1000
    for n, c, got in zip(highs, counts, draws, strict=True):
        np.testing.assert_array_equal(got, rng.integers(0, n, size=c))
    assert after == rng.bit_generator.state


def _centred(samples):
    usable = [s for s in samples if s.n > 1]
    st = [s.sum_terms() - s.sum_terms().mean() for s in usable]
    ct = [s.count_terms() - s.count_terms().mean() for s in usable]
    return st, ct


@pytest.mark.parametrize("flags,rows", [(plain.MOMENT_SUM, [0, 2]),
                                        (plain.MOMENT_COUNT, [1, 3]),
                                        (7, [0, 1, 2, 3, 4])])
def test_plain_resample_moments_equal_numpy(flags, rows):
    """The moments the card computes, by its draw scheme, against the numpy
    path's (``rng.integers`` and the reference's reductions): the rows the
    aggregate reads within 1e-12 of each row's largest, the rest 0, the
    Generator left where numpy leaves it."""
    st, ct = _centred(_strata(estimators, 5, k=7)[0])
    host_rng, plain_rng = _generator(4, True), _generator(4, True)
    want = np.array(bootstrap._moments_host(st, ct, 301, host_rng))
    got, _ = resample_moments(st if flags & plain.MOMENT_SUM else None,
                              ct if flags & plain.MOMENT_COUNT else None,
                              301, plain_rng, flags, device="cpu")
    assert plain_rng.bit_generator.state == host_rng.bit_generator.state
    scale = np.abs(want[rows]).max(axis=1, keepdims=True)
    assert (np.abs(got[rows] - want[rows]) <= 1e-12 * scale).all()
    assert not got[[r for r in range(5) if r not in rows]].any()


def test_bootstrap_counts_its_draws_on_the_host():
    mine, mb = _strata(estimators, 1)
    with telemetry.query() as q:
        bootstrap.bootstrap_t_ci(mine, mb, Agg.AVG, 0.95, 300, np.random.default_rng(1))
    assert q.counters == {"ci.draws_host": 300 * sum(s.n for s in mine if s.n > 1)}


@pytest.mark.parametrize("mix", [0.0, 0.2])
def test_samplers_bit_equal(mix):
    w = np.random.default_rng(5).random(1000) ** 3
    w[::7] = 0.0
    a = wander.flat_sample(w, 500, np.random.default_rng(1), mix)
    b = r_wander.flat_sample(w, 500, np.random.default_rng(1), mix)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    wr = np.random.default_rng(6).random((40, 30))
    a = wander._categorical_rows(wr, np.random.default_rng(2))
    b = r_wander._categorical_rows(wr, np.random.default_rng(2))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    x = np.random.default_rng(7).random(100)
    assert wander.clt_ci(x, 0.9)[0] == r_wander.clt_ci(x, 0.9)[0]


def test_walk_sample_matches_reference():
    """The walk draws the same uniforms in the same order; its per-row
    categorical runs in torch, so probabilities agree to f64 rounding."""
    rng = np.random.default_rng(8)
    embs = [rng.standard_normal((n, 8)).astype(np.float32) for n in (20, 25, 30)]
    embs = [e / np.linalg.norm(e, axis=1, keepdims=True) for e in embs]
    a = wander.walk_sample(embs, 300, np.random.default_rng(3), 2.0, 1e-3,
                           chunk=128, device="cpu")
    b = r_wander.walk_sample(embs, 300, np.random.default_rng(3), 2.0, 1e-3, chunk=128)
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_allclose(a.prob, b.prob, rtol=1e-6)


def _oracle_script(mod):
    truth = (np.random.default_rng(9).random((30, 40)) < 0.3).astype(np.int8)
    o = mod.ArrayOracle(truth)
    o.set_budget(200)
    batch = mod.OracleBatch(o)
    rng = np.random.default_rng(10)
    hs = [batch.submit(np.stack([rng.integers(0, 30, 60), rng.integers(0, 40, 60)], 1))
          for _ in range(3)]
    batch.flush()
    out = [h.labels for h in hs]
    try:
        o.label(np.stack([np.arange(30).repeat(40), np.tile(np.arange(40), 30)], 1))
    except mod.BudgetExceeded:
        out.append(np.array([-1.0]))
    out.append(o.label(np.array([[1, 2], [3, 4], [1, 2]])))
    chain = mod.PairChainOracle([truth, truth.T])
    out.append(chain.label(np.array([[0, 1, 2], [3, 4, 5]])))
    fn = mod.FnOracle(lambda idx: idx[:, 0] % 2)
    out.append(fn.label(np.array([[1, 0], [2, 0]])))
    return out, o.stats(), o._keys.copy()


def test_oracle_ledger_bit_equal():
    a, sa, ka = _oracle_script(oracle)
    b, sb, kb = _oracle_script(r_or)
    assert sa == sb
    np.testing.assert_array_equal(ka, kb)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def test_wire_payloads_bit_equal():
    idx = np.random.default_rng(11).integers(0, 1000, (17, 3))
    mine = oracle.LabelRequest(group="g", idx=idx, request_id=7).to_bytes()
    assert mine == r_or.LabelRequest(group="g", idx=idx, request_id=7).to_bytes()
    back = r_or.LabelRequest.from_bytes(mine)
    np.testing.assert_array_equal(back.idx, idx)
    labels = np.random.default_rng(12).random(9)
    res = oracle.LabelResult(request_id=3, labels=labels).to_bytes()
    assert res == r_or.LabelResult(request_id=3, labels=labels).to_bytes()
    err = oracle.LabelResult(request_id=4, error="ValueError: x")
    assert oracle.LabelResult.from_bytes(err.to_bytes()).error == "ValueError: x"
