"""The port's kernel ops (their plain PyTorch versions on the CPU) against
the reference's Pallas ops (interpret mode), on the ``PAIR_GRID`` shapes of
``tests/test_chain_stats.py`` and the sweep shapes of ``tests/test_kernels.py``,
at fp32, bf16 and int8.

Rules (``repro_torch.kernels.checks``): count tiles under the edge rule —
an element may sit in another bin only when its exact weight lies within the
f32 error band of a bin edge, which the check recomputes in f64; top-k under
the near-tie rule; walk sums within 1e-6 relative of an f64 sum over the
port's own f32 scores.  int8 at exponent 1 sums integers and applies two f32
products in a fixed order, so it must equal the reference bit for bit.
Within the port, the fp32 sweep equals the two-pass (sim_hist + sim_topk)
path bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.kernels.sim_hist import sim_hist as ref_sim_hist
from repro.kernels.sim_sweep import sim_sweep as ref_sim_sweep
from repro.kernels.sim_topk import sim_topk as ref_sim_topk
from repro_torch.configs.joinml_embedder import EMBEDDING_PRECISIONS
from repro_torch.core.similarity import normalize, quantize_rows_int8
from repro_torch.kernels import checks
from repro_torch.kernels.padding import pad_rows
from repro_torch.kernels.plain import ROW_CHUNK, scores_plain
from repro_torch.kernels.sim_hist import sim_hist
from repro_torch.kernels.sim_sweep import sim_sweep
from repro_torch.kernels.sim_sweep.ops import _pow2_block
from repro_torch.kernels.sim_topk import sim_topk

CPU = "cpu"


def _t(x):
    return torch.tensor(np.asarray(x))


def _unit(rng, n, d):
    e = rng.normal(size=(n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _exact(e1, e2, precision):
    """Exact f64 scores of the inputs as the kernels see them."""
    if precision == "int8":
        q1, r1 = quantize_rows_int8(e1)
        q2, r2 = quantize_rows_int8(e2)
        return checks.exact_scores(torch.from_numpy(q1), torch.from_numpy(q2), "int8",
                                   torch.from_numpy(r1[:, 0]), torch.from_numpy(r2[:, 0]))
    return checks.exact_scores(torch.from_numpy(e1), torch.from_numpy(e2), precision)


def _own_sums(e1, e2, precision, exponent, floor, v, block):
    """f64 walk sums over the port's own f32 scores (same padded shapes and
    row chunks as the plain sweep)."""
    n1, n2 = e1.shape[0], e2.shape[0]
    e1p, _ = pad_rows(e1, _pow2_block(block, n1))
    e2p, _ = pad_rows(e2, _pow2_block(block, n2))
    if precision == "int8":
        q1, r1 = quantize_rows_int8(e1p)
        q2, r2 = quantize_rows_int8(e2p)
        args = [torch.from_numpy(x) for x in (q1, q2, r1[:, 0], r2[:, 0])]
    else:
        args = [torch.from_numpy(e1p), torch.from_numpy(e2p), None, None]
    out = []
    for s in range(0, n1, ROW_CHUNK):
        sc = scores_plain(args[0][s:s + ROW_CHUNK], args[1], precision,
                          None if args[2] is None else args[2][s:s + ROW_CHUNK],
                          args[3])[:, :n2].double()
        w = torch.clamp(sc, 0.0, 1.0).clamp_min(float(np.float32(floor)))
        if exponent != 1.0:
            w = w ** float(np.float32(exponent))
        out.append((w * torch.from_numpy(v.astype(np.float64))).sum(dim=1))
    return torch.cat(out)[:n1].numpy()


def _compare_sweeps(e1, e2, *, precision, exponent, floor, k, n_bins, block,
                    scale=None, v=None):
    kw = dict(n_bins=n_bins, exponent=exponent, floor=floor, k=k, block=block,
              scale=scale, precision=precision, back_v=v)
    mine = sim_sweep(e1, e2, device=CPU, **kw)
    ref = ref_sim_sweep(e1, e2, **kw)
    n1, n2 = e1.shape[0], e2.shape[0]
    assert mine.block_rows == ref.block_rows
    assert mine.block_counts.shape == ref.block_counts.shape
    np.testing.assert_array_equal(mine.edges, ref.edges)
    np.testing.assert_array_equal(mine.block_counts.sum(axis=0), mine.counts)
    assert int(mine.counts.sum()) == n1 * n2
    s64, bound = _exact(e1, e2, precision)
    sc = None if scale is None else torch.from_numpy(np.asarray(scale, np.float32))
    c = checks.check_counts(
        [_t(mine.block_counts), _t(ref.block_counts)],
        s64, bound, n_bins=n_bins, exponent=exponent, floor=floor,
        bm=mine.block_rows, scale=sc)
    t = checks.check_topk(_t(mine.vals), _t(mine.idx), _t(ref.vals), _t(ref.idx),
                          s64, bound)
    same = mine.idx == ref.idx
    np.testing.assert_array_equal(mine.valid[same], ref.valid[same])
    vv = np.ones(n2, np.float32) if v is None else np.asarray(v, np.float32)
    own = _own_sums(e1, e2, precision, exponent, floor, vv, block)
    np.testing.assert_allclose(mine.row_sums, own, rtol=1e-6)
    if precision == "int8" and exponent == 1.0:
        np.testing.assert_array_equal(mine.block_counts, ref.block_counts)
        np.testing.assert_array_equal(mine.vals, ref.vals)
        np.testing.assert_array_equal(mine.idx, ref.idx)
    return mine, ref, c, t


# (seed, n1, n2, d, exponent, floor, decades) — tests/test_chain_stats.py
PAIR_GRID = [
    (0, 50, 70, 16, 1.0, 1e-3, 0.0),
    (1, 33, 190, 32, 2.5, 1e-2, 2.0),
    (2, 130, 65, 48, 4.0, 1e-4, 4.0),
    (3, 7, 260, 8, 3.0, 1e-3, 4.0),
    (4, 64, 64, 24, 1.5, 1e-2, 3.0),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", PAIR_GRID, ids=lambda c: f"seed{c[0]}")
def test_sweep_matches_reference_pair_grid(case, precision):
    seed, n1, n2, d, exponent, floor, decades = case
    rng = np.random.default_rng(seed)
    e1, e2 = _unit(rng, n1, d), _unit(rng, n2, d)
    v = (10.0 ** rng.uniform(-decades, decades, n2)).astype(np.float32)
    _compare_sweeps(e1, e2, precision=precision, exponent=exponent, floor=floor,
                    k=8, n_bins=64, block=64, v=v)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m,n,d,k", [(64, 64, 16, 4), (128, 64, 32, 8), (100, 70, 16, 8)])
def test_sweep_matches_reference_kernel_shapes(m, n, d, k, precision):
    rng = np.random.default_rng(10)
    e1 = normalize(rng.standard_normal((m, d)))
    e2 = normalize(rng.standard_normal((n, d)))
    _compare_sweeps(e1, e2, precision=precision, exponent=1.0, floor=1e-3, k=k,
                    n_bins=256, block=256)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_sweep_scale_and_exponent_match_reference(precision):
    rng = np.random.default_rng(11)
    e1 = normalize(rng.standard_normal((96, 16)))
    e2 = normalize(rng.standard_normal((80, 16)))
    scale = rng.random(96).astype(np.float32)
    _compare_sweeps(e1, e2, precision=precision, exponent=0.5, floor=1e-3, k=4,
                    n_bins=128, block=256, scale=scale)


@pytest.mark.parametrize("m,n,d,k", [(64, 64, 16, 4), (128, 64, 32, 8), (100, 70, 16, 8)])
def test_fp32_sweep_bit_identical_to_two_pass(m, n, d, k):
    rng = np.random.default_rng(10)
    e1 = normalize(rng.standard_normal((m, d)))
    e2 = normalize(rng.standard_normal((n, d)))
    sw = sim_sweep(e1, e2, n_bins=256, k=k, device=CPU)
    counts, _ = sim_hist(e1, e2, n_bins=256, device=CPU)
    vals, idx, valid = sim_topk(e1, e2, k=k, device=CPU)
    np.testing.assert_array_equal(sw.counts, counts)
    np.testing.assert_array_equal(sw.vals, vals)
    np.testing.assert_array_equal(sw.idx, idx)
    np.testing.assert_array_equal(sw.valid, valid)
    scale = rng.random(m).astype(np.float32)
    sw = sim_sweep(e1, e2, n_bins=128, exponent=0.5, scale=scale, device=CPU)
    counts, _ = sim_hist(e1, e2, n_bins=128, exponent=0.5, scale=scale, device=CPU)
    np.testing.assert_array_equal(sw.counts, counts)


@pytest.mark.parametrize("m,n,d", [(64, 64, 16), (128, 64, 32), (256, 128, 8), (37, 50, 16)])
@pytest.mark.parametrize("exponent", [0.5, 1.0, 2.0])
def test_sim_hist_matches_reference(m, n, d, exponent):
    rng = np.random.default_rng(m + n + d)
    e1, e2 = _unit(rng, m, d), _unit(rng, n, d)
    scale = rng.random(m).astype(np.float32) if m == 37 else None
    mine, edges = sim_hist(e1, e2, n_bins=128, exponent=exponent, scale=scale,
                           device=CPU)
    ref, ref_edges = ref_sim_hist(e1, e2, n_bins=128, exponent=exponent, scale=scale)
    np.testing.assert_array_equal(edges, ref_edges)
    s64, bound = _exact(e1, e2, "fp32")
    checks.check_counts([_t(mine)[None], _t(ref)[None]],
                        s64, bound, n_bins=128, exponent=exponent, floor=1e-3, bm=m,
                        scale=None if scale is None else torch.from_numpy(scale))


@pytest.mark.parametrize("m,n,d,k", [(64, 128, 16, 4), (128, 256, 32, 8),
                                     (64, 64, 8, 16), (5, 6, 8, 8)])
def test_sim_topk_matches_reference(m, n, d, k):
    rng = np.random.default_rng(m * n + k)
    e1, e2 = _unit(rng, m, d), _unit(rng, n, d)
    mine = sim_topk(e1, e2, k=k, device=CPU)
    ref = ref_sim_topk(e1, e2, k=k)
    assert mine[0].shape == ref[0].shape
    s64, bound = _exact(e1, e2, "fp32")
    checks.check_topk(*(_t(x) for x in (mine[0], mine[1], ref[0], ref[1])),
                      s64, bound)
    same = mine[1] == ref[1]
    np.testing.assert_array_equal(mine[2][same], ref[2][same])
    if n < k:  # padded columns come last and are flagged invalid
        assert not mine[2][:, n:].any()


def test_duplicated_rows_drive_the_wide_retry():
    """Hot left rows with more than 128 qualifying right rows each: the
    sweep's top-32 saturates, the k=128 retry runs and saturates too, and
    the exact rescan still collects exactly the dense-scan set — the same
    set the reference collects."""
    from repro.core.stratify import collect_top as ref_collect_top
    from repro.core.stratify import sweep_pass as ref_sweep_pass
    from repro_torch.core.similarity import pair_weights
    from repro_torch.core.stratify import collect_top, sweep_pass

    rng = np.random.default_rng(24)
    base = normalize(rng.standard_normal((1, 16)))
    hot = np.repeat(base, 4, axis=0)  # duplicated rows
    cold = normalize(rng.standard_normal((60, 16)))
    e1 = np.concatenate([hot, cold])
    e2 = normalize(base + 0.01 * rng.standard_normal((200, 16)))
    w = pair_weights(e1, e2, device=CPU)
    ws = np.sort(w.reshape(-1))
    m_cap = 700
    thr = float((ws[-m_cap] + ws[-m_cap - 1]) / 2)
    assert (w[:4] >= thr).sum(axis=1).min() > 128
    sw = sweep_pass(e1, e2, n_bins=512, use_kernel=True, device=CPU)
    got = collect_top(e1, e2, thr, m_cap, use_kernel=True, sweep=sw, device=CPU)
    want = collect_top(e1, e2, thr, m_cap, use_kernel=False, device=CPU)
    assert set(got.tolist()) == set(want.tolist()) and len(got) == m_cap
    assert sw.stats["topk_retry_rows"] == 4
    assert sw.stats["dense_rescan_rows"] == 4
    rsw = ref_sweep_pass(e1, e2, n_bins=512, use_kernel=True)
    ref = ref_collect_top(e1, e2, thr, m_cap, use_kernel=True, sweep=rsw)
    assert set(got.tolist()) == set(ref.tolist())


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_low_precision_within_tolerance(precision):
    rng = np.random.default_rng(13)
    e1 = normalize(rng.standard_normal((100, 32)))
    e2 = normalize(rng.standard_normal((90, 32)))
    ref = sim_sweep(e1, e2, n_bins=256, k=8, device=CPU)
    low = sim_sweep(e1, e2, n_bins=256, k=8, precision=precision, device=CPU)
    assert int(low.counts.sum()) == 100 * 90
    dev = np.abs(np.cumsum(ref.counts) - np.cumsum(low.counts)) / ref.counts.sum()
    assert dev.max() <= EMBEDDING_PRECISIONS[precision].max_cdf_shift


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_topk_splits_are_whole_ranges(sms):
    """The column split of a top-k launch covers every column tile once, in
    ranges of ceil(tiles / splits) tiles, and never more than the merge
    takes; launches with a CTA row per SM or more do not split."""
    from repro_torch.kernels.cuda_lib import CTA_COLS, CTA_ROWS, MAX_SPLITS, topk_splits

    for m in (1, 8, 64, 65, 300, 4096, 32768):
        for n in (1, 63, 64, 1000, 5000, 32768, 100000):
            s = topk_splits(m, n, sms)
            tiles = -(-n // CTA_COLS)
            per = -(-tiles // s)
            assert 1 <= s <= min(tiles, MAX_SPLITS)
            assert -(-tiles // per) == s  # the kernel's own check
            if -(-m // CTA_ROWS) >= 2 * sms:
                assert s == 1
