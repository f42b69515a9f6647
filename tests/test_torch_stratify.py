"""Stratification of the port against the reference on the fixtures of
``tests/test_core_stratify.py``, for 2-way and 3-way inputs.

Strata and the collected top sets must equal the reference's; the only
slack is for elements the edge rule excuses — a tuple whose exact weight
lies within the f32 error band of the threshold may sit on either side of
it, and tuples within that band of each other may swap places in the
descending order.
"""
import numpy as np
import pytest

from repro.core import stratify as ref_st
from repro.core.types import BASConfig as RefCfg
from repro_torch.core import stratify as st
from repro_torch.core.similarity import chain_tuple_weights, normalize
from repro_torch.core.types import BASConfig

CFG, REF_CFG = BASConfig(), RefCfg()
BAND = 1e-6  # f32 error band of these small-d weights (d <= 32), generous


def _assert_same_strata(mine, ref, embeddings, thr_w=None):
    np.testing.assert_array_equal(mine.bounds, ref.bounds)
    assert mine.n_total == ref.n_total
    if np.array_equal(mine.order, ref.order):
        return
    sizes = tuple(e.shape[0] for e in embeddings)
    from repro_torch.core.similarity import flat_to_tuples

    def w(flat):
        return chain_tuple_weights(embeddings, flat_to_tuples(flat, sizes),
                                   CFG.weight_exponent, CFG.weight_floor)

    diff = mine.order != ref.order
    # swaps only between near-equal weights
    assert np.all(np.abs(w(mine.order[diff]) - w(ref.order[diff])) <= BAND)
    only = np.setxor1d(mine.order, ref.order)
    if len(only):
        assert thr_w is not None and np.all(np.abs(w(only) - thr_w) <= BAND)


def _pair(seed, n1=130, n2=90, d=16):
    rng = np.random.default_rng(seed)
    return (normalize(rng.standard_normal((n1, d))),
            normalize(rng.standard_normal((n2, d))))


@pytest.mark.parametrize("use_kernel,use_sweep", [(True, True), (True, False),
                                                  (False, True), (False, False)])
@pytest.mark.parametrize("budget", [900, 2500, 12000])
def test_two_way_strata_match_reference(use_kernel, use_sweep, budget):
    e1, e2 = _pair(21)
    mine = st.stratify_streaming(e1, e2, 0.2, budget, CFG, use_kernel=use_kernel,
                                 use_sweep=use_sweep, device="cpu")
    ref = ref_st.stratify_streaming(e1, e2, 0.2, budget, REF_CFG,
                                    use_kernel=use_kernel, use_sweep=use_sweep)
    _assert_same_strata(mine, ref, [e1, e2])
    if use_sweep:
        assert mine.sweep.kernel == ref.sweep.kernel == use_kernel
        assert mine.sweep.block_rows == ref.sweep.block_rows
    np.testing.assert_allclose(mine.order_weights, ref.order_weights, atol=BAND)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_two_way_low_precision_strata_match_reference(precision):
    e1, e2 = _pair(22, 150, 140, 32)
    mine = st.stratify_streaming(e1, e2, 0.2, 2500, CFG, use_kernel=True,
                                 precision=precision, device="cpu")
    ref = ref_st.stratify_streaming(e1, e2, 0.2, 2500, REF_CFG, use_kernel=True,
                                    precision=precision)
    _assert_same_strata(mine, ref, [e1, e2])
    assert mine.sweep.precision == ref.sweep.precision == precision
    assert mine.sweep.stats["lowp_cdf_dev"] == pytest.approx(
        ref.sweep.stats["lowp_cdf_dev"], abs=1e-3)


def test_sweep_bit_identical_to_two_pass_in_port():
    e1, e2 = _pair(21)
    one = st.stratify_streaming(e1, e2, 0.2, 2500, CFG, use_kernel=True,
                                use_sweep=True, device="cpu")
    two = st.stratify_streaming(e1, e2, 0.2, 2500, CFG, use_kernel=True,
                                use_sweep=False, device="cpu")
    np.testing.assert_array_equal(one.order, two.order)
    np.testing.assert_array_equal(one.bounds, two.bounds)
    np.testing.assert_array_equal(one.order_weights, two.order_weights)


@pytest.mark.parametrize("use_kernel,use_sweep", [(True, True), (True, False),
                                                  (False, True)])
@pytest.mark.parametrize("sizes", [(12, 14, 16), (20, 9, 33)])
def test_three_way_strata_match_reference(sizes, use_kernel, use_sweep):
    rng = np.random.default_rng(sum(sizes))
    embs = [normalize(rng.standard_normal((n, 16))) for n in sizes]
    kw = dict(use_kernel=use_kernel, use_sweep=use_sweep)
    mine = st.stratify_streaming_chain(embs, 0.2, 1500, CFG, device="cpu", **kw)
    ref = ref_st.stratify_streaming_chain(embs, 0.2, 1500, REF_CFG, **kw)
    _assert_same_strata(mine, ref, embs)
    if use_sweep:
        np.testing.assert_array_equal(mine.sweep.block_counts.sum(axis=0),
                                      mine.sweep.counts)
        assert mine.sweep.total_weight == pytest.approx(ref.sweep.total_weight,
                                                        rel=1e-6)
        for a, b in zip(mine.sweep.row_sums, ref.sweep.row_sums):
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_dense_strata_bit_equal_on_the_same_weights():
    w = np.random.default_rng(3).random(5000)
    mine = st.stratify_dense(w, 0.2, 4000, CFG)
    ref = ref_st.stratify_dense(w, 0.2, 4000, REF_CFG)
    np.testing.assert_array_equal(mine.order, ref.order)
    np.testing.assert_array_equal(mine.bounds, ref.bounds)
    for m in (0, 1, 37, 10**6):
        counts = np.random.default_rng(m).integers(0, 9, 64)
        edges = np.linspace(0, 1, 65)
        assert st.threshold_for_top_m(counts, edges, m) == \
            ref_st.threshold_for_top_m(counts, edges, m)


def test_block_skipping_matches_full_scan():
    rng = np.random.default_rng(23)
    base = normalize(rng.standard_normal((1, 16)))
    near = normalize(base + 0.05 * rng.standard_normal((64, 16)))
    far = normalize(rng.standard_normal((192, 16)))
    e1 = np.concatenate([near, far])
    e2 = normalize(base + 0.05 * rng.standard_normal((40, 16)))
    sw = st.sweep_pass(e1, e2, n_bins=512, block=64, device="cpu")
    thr = st.threshold_for_top_m(sw.counts, sw.edges, 200)
    got = st.collect_top(e1, e2, thr, 200, sweep=sw, device="cpu")
    want = st.collect_top(e1, e2, thr, 200, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert sw.stats["blocks_rescanned"] < sw.stats["blocks_total"]
    rsw = ref_st.sweep_pass(e1, e2, n_bins=512, block=64)
    np.testing.assert_array_equal(got, ref_st.collect_top(e1, e2, thr, 200, sweep=rsw))


def test_precision_validation_and_index_not_ported():
    e1, e2 = _pair(26, 32, 32, 8)
    for use_kernel in (True, False):
        with pytest.raises(ValueError, match="unknown sweep precision"):
            st.sweep_pass(e1, e2, use_kernel=use_kernel, precision="fp4",
                          device="cpu")
    with pytest.warns(UserWarning, match="falling back to fp32"):
        sw = st.sweep_pass(e1, e2, n_bins=256, use_kernel=True, precision="bf16",
                           tolerance=0.0, device="cpu")
    assert sw.precision == "fp32" and "lowp_fallback" in sw.stats
    with pytest.warns(UserWarning, match="host path computes fp32"):
        st.sweep_pass(e1, e2, use_kernel=False, precision="int8", device="cpu")
    # an index artifact (ROADMAP item 6) hydrates when it
    # covers these tables and this binning, and raises otherwise
    from repro_torch.core import build_index

    art = build_index([e1, e2], n_bins=256, device="cpu")
    assert st.sweep_pass(e1, e2, n_bins=256, artifact=art,
                         device="cpu").stats["index_version"] == 1
    with pytest.raises(ValueError, match="n_bins"):
        st.sweep_pass(e1, e2, n_bins=512, artifact=art, device="cpu")
    with pytest.raises(ValueError, match="covers tables"):
        st.sweep_pass(e1[:20], e2, n_bins=256, artifact=art, device="cpu")
