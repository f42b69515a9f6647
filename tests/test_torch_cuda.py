"""The CUDA kernels against their plain PyTorch versions, on the card
(marker ``cuda``; run with ``pytest -m cuda tests/test_torch_cuda.py``): the
similarity kernels K1-K4, then the model-stack kernels K5-K7 and the models
that run them, and the bootstrap-t's resampling K8 against the numpy path.

Whether a card is present is decided inside the ``card`` fixture, so every
worker collects the same tests; without a card they skip.

Tolerances (see ``repro_torch.kernels.checks``): counts under the edge rule,
top-k under the near-tie rule, walk sums within 1e-6 relative of f64; the
fp32 and bf16 sweeps equal their two-pass kernels bit for bit, and the
few-row top-k equals the fp32 sweep; int8 equals its plain version bit for
bit in counts and top-k (integer sums, two f32 products in a fixed
order).  The model-stack kernels follow
``checks.check_model_kernel``: within twice the f32 error bound of their
function (``checks.*_bound``), plus half a bf16 ulp on each side for a bf16
output; a model's logits on the card against the
CPU's at f32 within 2e-5 of the largest |logit| (the tolerance of
``test_torch_models.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import checks, cuda_lib
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.kernels.sim_hist.kernel import sim_hist_cuda
from repro_torch.kernels.sim_hist.ref import sim_hist_ref
from repro_torch.kernels.sim_sweep.kernel import kernel_operand, sim_sweep_cuda
from repro_torch.kernels.sim_sweep.ref import sim_sweep_ref
from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda
from repro_torch.kernels.sim_topk.ref import sim_topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unit(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _inputs(card, m, n, d, precision, seed=0):
    from repro_torch.core.similarity import quantize_rows_int8

    rng = np.random.default_rng(seed)
    e1, e2 = _unit(rng, m, d), _unit(rng, n, d)
    if precision == "int8":
        q1, r1 = quantize_rows_int8(e1)
        q2, r2 = quantize_rows_int8(e2)
        t = [torch.from_numpy(x).to(card) for x in (q1, q2, r1.reshape(-1), r2.reshape(-1))]
        return t[0], t[1], t[2], t[3]
    return (torch.from_numpy(e1).to(card), torch.from_numpy(e2).to(card),
            None, None)


SHAPES = [(64, 64, 16, 4), (100, 70, 16, 8), (256, 300, 48, 32), (130, 65, 48, 8)]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m,n,d,k", SHAPES)
@pytest.mark.parametrize("exponent", [1.0, 2.5])
def test_sweep_matches_plain(card, precision, m, n, d, k, exponent):
    a, b, rs1, rs2 = _inputs(card, m, n, d, precision)
    rng = np.random.default_rng(1)
    scale = torch.from_numpy(rng.random(m).astype(np.float32)).to(card)
    v = torch.from_numpy((10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)).to(card)
    bm = 64 if m > 64 else m
    kw = dict(n_bins=256, exponent=exponent, floor=1e-3, k=k, bm=bm,
              precision=precision, rs1=rs1, rs2=rs2)
    kb, kv, ki, ks = sim_sweep_cuda(kernel_operand(a, precision),
                                    kernel_operand(b, precision), scale, v, **kw)
    torch.cuda.synchronize()
    pb, pv, pi, ps = sim_sweep_ref(a, b, scale, v, **kw)
    s64, bound = checks.exact_scores(a, b, precision, rs1, rs2)
    checks.check_counts([kb, pb], s64, bound, n_bins=256, exponent=exponent,
                        floor=1e-3, bm=bm, scale=scale)
    checks.check_topk(kv, ki, pv, pi, s64, bound)
    checks.check_sums(ks, s64, exponent=exponent, floor=1e-3, v=v)
    assert int(kb.sum()) == m * n
    if precision == "int8" and exponent == 1.0:
        assert torch.equal(kb, pb) and torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("m,n,d,k", SHAPES)
def test_fp32_sweep_bit_identical_to_two_pass(card, m, n, d, k):
    a, b, _, _ = _inputs(card, m, n, d, "fp32", seed=2)
    scale = torch.ones(m, device=card)
    v = torch.ones(n, device=card)
    a4, b4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    bc, vals, idx, _ = sim_sweep_cuda(a4, b4, scale, v, n_bins=512, k=k,
                                      bm=m if m <= 64 else 64)
    hist = sim_hist_cuda(a4, b4, scale, n_bins=512)
    tv, ti = sim_topk_cuda(a4, b4, k=k)
    torch.cuda.synchronize()
    assert torch.equal(bc.sum(dim=0), hist)
    assert torch.equal(vals, tv) and torch.equal(idx, ti)
    # and the plain two-pass pair holds the same rules
    s64, bound = checks.exact_scores(a, b)
    checks.check_counts([hist[None], sim_hist_ref(a, b, scale, n_bins=512)[None]],
                        s64, bound, n_bins=512, exponent=1.0, floor=1e-3, bm=m)


@pytest.mark.parametrize("m,n,d,k", SHAPES)
def test_bf16_sweep_bit_identical_to_two_pass(card, m, n, d, k):
    """The bf16 sweep, histogram and top-k launches take every score through
    the same mmas and flushes: the sweep equals the two-pass launches."""
    a, b, _, _ = _inputs(card, m, n, d, "bf16", seed=2)
    scale = torch.ones(m, device=card)
    v = torch.ones(n, device=card)
    a2, b2 = kernel_operand(a, "bf16"), kernel_operand(b, "bf16")
    bc, vals, idx, _ = sim_sweep_cuda(a2, b2, scale, v, n_bins=512, k=k,
                                      bm=m if m <= 64 else 64, precision="bf16")
    hist = sim_hist_cuda(a2, b2, scale, n_bins=512, precision="bf16")
    tv, ti = sim_topk_cuda(a2, b2, k=k, precision="bf16")
    torch.cuda.synchronize()
    assert torch.equal(bc.sum(dim=0), hist)
    assert torch.equal(vals, tv) and torch.equal(idx, ti)
    s64, bound = checks.exact_scores(a, b, "bf16")
    checks.check_counts([hist[None], sim_hist_ref(a.bfloat16(), b.bfloat16(), scale,
                                                  n_bins=512)[None]],
                        s64, bound, n_bins=512, exponent=1.0, floor=1e-3, bm=m)
    checks.check_topk(tv, ti, *sim_topk_ref(a.bfloat16(), b.bfloat16(), k=k), s64, bound)


@pytest.mark.parametrize("d", [40, 100])
def test_bf16_sweep_padded_width(card, d):
    """A width that is not a multiple of a 64-column ring slice: the slice's
    tail is zero-filled (zero products add exact zeros)."""
    a, b, _, _ = _inputs(card, 300, 700, d, "bf16", seed=13)
    rng = np.random.default_rng(14)
    scale = torch.from_numpy(rng.random(300).astype(np.float32)).to(card)
    v = torch.from_numpy((10.0 ** rng.uniform(-1, 1, 700)).astype(np.float32)).to(card)
    kw = dict(n_bins=256, exponent=1.0, floor=1e-3, k=16, bm=64, precision="bf16")
    a2, b2 = kernel_operand(a, "bf16"), kernel_operand(b, "bf16")
    kb, kv, ki, ks = sim_sweep_cuda(a2, b2, scale, v, **kw)
    torch.cuda.synchronize()
    pb, pv, pi, _ = sim_sweep_ref(a, b, scale, v, **kw)
    s64, bound = checks.exact_scores(a, b, "bf16")
    checks.check_counts([kb, pb], s64, bound, n_bins=256, exponent=1.0, floor=1e-3,
                        bm=64, scale=scale)
    checks.check_topk(kv, ki, pv, pi, s64, bound)
    checks.check_sums(ks, s64, exponent=1.0, floor=1e-3, v=v)
    assert int(kb.sum()) == 300 * 700


@pytest.mark.parametrize("k", [32, 128])
def test_topk_wide_k_matches_plain(card, k):
    a, b, _, _ = _inputs(card, 96, 1000, 64, "fp32", seed=3)
    # duplicated right rows force exact ties: the lower column must win
    b = torch.cat([b, b[:200]]).contiguous()
    kv, ki = sim_topk_cuda(kernel_operand(a, "fp32"), kernel_operand(b, "fp32"), k=k)
    torch.cuda.synchronize()
    pv, pi = sim_topk_ref(a, b, k=k)
    s64, bound = checks.exact_scores(a, b)
    checks.check_topk(kv, ki, pv, pi, s64, bound)
    assert (torch.sort(ki, dim=1).values.diff(dim=1) > 0).all()


def test_sweep_chain_prefix_matches_plain(card):
    """The fp32 sweep as a 3-way chain calls it: binned at exponent 0.5 with
    a per-row scale, walk sums at the raw exponent 1, top-1."""
    a, b, _, _ = _inputs(card, 300, 700, 48, "fp32", seed=6)
    scale = torch.from_numpy(
        np.random.default_rng(7).random(300).astype(np.float32) ** 0.5).to(card)
    v = torch.ones(700, device=card)
    kw = dict(n_bins=512, exponent=0.5, rs_exponent=1.0, floor=1e-3, k=1, bm=64)
    kb, kv, ki, ks = sim_sweep_cuda(kernel_operand(a, "fp32"),
                                    kernel_operand(b, "fp32"), scale, v, **kw)
    torch.cuda.synchronize()
    pb, pv, pi, _ = sim_sweep_ref(a, b, scale, v, **kw)
    s64, bound = checks.exact_scores(a, b)
    checks.check_counts([kb, pb], s64, bound, n_bins=512, exponent=0.5,
                        floor=1e-3, bm=64, scale=scale)
    checks.check_topk(kv, ki, pv, pi, s64, bound)
    checks.check_sums(ks, s64, exponent=1.0, floor=1e-3, v=v)


@pytest.mark.parametrize("m", [1, 8, 70])
def test_topk_few_rows_split_matches_unsplit(card, m):
    """A few-row launch splits its columns across CTAs and merges the lists
    (the sweep at every m, and the tile kernel's top-k launch above
    ``cuda_lib.FEW_ROWS`` rows; below it the top-k takes the few-row
    kernels); the top-k equals the split sweep's bit for bit."""
    a, b, _, _ = _inputs(card, m, 5000, 64, "fp32", seed=8)
    a = torch.cat([b[:4], a]).contiguous()  # rows with exact duplicates in b
    b = torch.cat([b, b[:300]]).contiguous()  # exact ties across the ranges
    a4, b4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert cuda_lib.topk_splits(a.shape[0], b.shape[0], sms) > 1
    kv, ki = sim_topk_cuda(a4, b4, k=128)
    ones = torch.ones(a.shape[0], device=card)
    _, sv, si, _ = sim_sweep_cuda(a4, b4, ones, torch.ones(b.shape[0], device=card),
                                  n_bins=64, k=128, bm=64)
    torch.cuda.synchronize()
    assert torch.equal(kv, sv) and torch.equal(ki, si)
    pv, pi = sim_topk_ref(a, b, k=128)
    s64, bound = checks.exact_scores(a, b)
    checks.check_topk(kv, ki, pv, pi, s64, bound)


# the int8 sweep on the tensor cores: (M, N, d, k, count-tile rows, exponent)
INT8_CASES = [
    (300, 5000, 48, 32, 64, 1.0),     # ragged M and N; a partial 128-byte slice; 64-row tile
    (300, 5000, 400, 32, 256, 1.0),   # three slices and a 16-byte tail; 128-row tile
    (300, 5000, 48, 32, 256, 2.5),    # a non-unit exponent (the powf branch)
    (8, 9000, 64, 32, 8, 1.0),        # a few-row launch: its columns split
    (96, 3000, 64, 128, 64, 1.0),     # k 128: the 64-row tile
]


@pytest.mark.parametrize("m,n,d,k,bm,exponent", INT8_CASES)
def test_int8_tensor_core_sweep_bit_identical(card, m, n, d, k, bm, exponent):
    """The int8 product on the tensor cores sums exactly in s32 and scales
    as the plain version does: counts and top-k equal it bit for bit, and
    the walk sums lie within 1e-6 of f64."""
    a, b, rs1, rs2 = _inputs(card, m, n, d, "int8", seed=15)
    rng = np.random.default_rng(16)
    scale = torch.from_numpy(rng.random(m).astype(np.float32)).to(card)
    v = torch.from_numpy((10.0 ** rng.uniform(-1, 1, n)).astype(np.float32)).to(card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rows = cuda_lib.tile_rows(m, bm)
    if k > 32:
        rows = cuda_lib.CTA_ROWS  # the wide tile's lists do not fit
    assert rows == (128 if bm == 256 else 64)
    if m < cuda_lib.CTA_ROWS:
        assert cuda_lib.column_splits(m, n, sms, rows) > 1
    kw = dict(n_bins=1024, exponent=exponent, floor=1e-3, k=k, bm=bm, precision="int8",
              rs1=rs1, rs2=rs2)
    kc, kv, ki, ks = sim_sweep_cuda(kernel_operand(a, "int8"), kernel_operand(b, "int8"),
                                    scale, v, **kw)
    torch.cuda.synchronize()
    pc, pv, pi, _ = sim_sweep_ref(a, b, scale, v, **kw)
    assert torch.equal(kc, pc) and torch.equal(kv, pv) and torch.equal(ki, pi)
    s64, _ = checks.exact_scores(a, b, "int8", rs1, rs2)
    checks.check_sums(ks, s64, exponent=exponent, floor=1e-3, v=v)


def _few_row_inputs(card, m, n, d=64):
    """m rows against n (+ 300 duplicated) columns: row 0 is zero (every
    score 0: the lowest columns win), row 1 a column of E2, which E2 holds
    twice (an exact tie at the top)."""
    a, b, _, _ = _inputs(card, m, n, d, "fp32", seed=17)
    b = torch.cat([b, b[:300]]).contiguous()
    a = a.clone()
    a[0] = 0.0
    if m > 1:
        a[1] = b[min(7, n - 1)]
    return a, b


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("m", [1, 8, 32, 33])
def test_topk_few_row_kernel_matches_sweep(card, m, d):
    """A fp32 top-k launch over at most ``cuda_lib.FEW_ROWS`` rows takes the
    few-row kernels (just above the cut, the tile kernel): its lists equal
    the fp32 sweep's over the same rows bit for bit, at k 1, 32 and 128, at
    whole 128-byte k-slices (d 64) and with a partial last slice (d 100)."""
    a, b = _few_row_inputs(card, m, 5000, d)
    assert cuda_lib.few_rows("fp32", cuda_lib.TOPK, m) == (m <= cuda_lib.FEW_ROWS)
    a4, b4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    ones_m, ones_n = torch.ones(m, device=card), torch.ones(b.shape[0], device=card)
    s64, bound = checks.exact_scores(a, b)
    for k in (1, 32, 128):
        kv, ki = sim_topk_cuda(a4, b4, k=k)
        _, sv, si, _ = sim_sweep_cuda(a4, b4, ones_m, ones_n, n_bins=64, k=k, bm=m)
        torch.cuda.synchronize()
        assert torch.equal(kv, sv) and torch.equal(ki, si)
        checks.check_topk(kv, ki, *sim_topk_ref(a, b, k=k), s64, bound)
        assert torch.equal(ki[0].cpu(), torch.arange(k, dtype=torch.int32))
        assert not kv[0].any()


def test_topk_few_row_kernel_wide_tie_bin(card):
    """A row whose chosen top-digit bin holds more keys than the selection
    keeps in shared memory (the zero row: all 20,300 scores tie at 0) is
    counted from device memory on every pass; its lists still equal the
    fp32 sweep's, the lowest columns first."""
    a, b = _few_row_inputs(card, 8, 20000)
    a4, b4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    kv, ki = sim_topk_cuda(a4, b4, k=128)
    _, sv, si, _ = sim_sweep_cuda(a4, b4, torch.ones(8, device=card),
                                  torch.ones(b.shape[0], device=card), n_bins=64, k=128, bm=8)
    torch.cuda.synchronize()
    assert torch.equal(kv, sv) and torch.equal(ki, si)
    assert torch.equal(ki[0].cpu(), torch.arange(128, dtype=torch.int32))
    s64, bound = checks.exact_scores(a, b)
    checks.check_topk(kv, ki, *sim_topk_ref(a, b, k=128), s64, bound)


@pytest.mark.parametrize("n", [1, 200, 1000])
def test_topk_few_row_kernel_whole_row(card, n):
    """k = N: every column, in order (1,000 columns: the passes run into
    the column's bits for the zero row)."""
    a, b = _few_row_inputs(card, 8, n)
    b = b[:n].contiguous()
    kv, ki = sim_topk_cuda(kernel_operand(a, "fp32"), kernel_operand(b, "fp32"), k=n)
    torch.cuda.synchronize()
    pv, pi = sim_topk_ref(a, b, k=n)
    s64, bound = checks.exact_scores(a, b)
    checks.check_topk(kv, ki, pv, pi, s64, bound)
    assert (torch.sort(ki, dim=1).values == torch.arange(n, device=card)).all()


@pytest.mark.parametrize("bm", [64, 192, 256])
def test_fp32_sweep_wide_and_narrow_tiles_bit_identical(card, bm):
    """M = 300 is not a multiple of 128: count tiles of 64 or 192 rows take
    the 64-row tile, 256 the 128-row tile; the two-pass kernels (one count
    tile, the 128-row tile) compute every score by the same fmaf chain, so
    the sweep equals them bit for bit either way."""
    a, b, _, _ = _inputs(card, 300, 1100, 96, "fp32", seed=9)
    rows = cuda_lib.tile_rows(300, bm)
    assert rows == (128 if bm == 256 else 64)
    scale = torch.ones(300, device=card)
    v = torch.ones(1100, device=card)
    a4, b4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    bc, vals, idx, sums = sim_sweep_cuda(a4, b4, scale, v, n_bins=512, k=16, bm=bm)
    hist = sim_hist_cuda(a4, b4, scale, n_bins=512)
    tv, ti = sim_topk_cuda(a4, b4, k=16)
    torch.cuda.synchronize()
    assert bc.shape[0] == -(-300 // bm)
    assert torch.equal(bc.sum(dim=0), hist)
    assert torch.equal(vals, tv) and torch.equal(idx, ti)
    s64, bound = checks.exact_scores(a, b)
    pb, pv, pi, _ = sim_sweep_ref(a, b, scale, v, n_bins=512, k=16, bm=bm)
    checks.check_counts([bc, pb], s64, bound, n_bins=512, exponent=1.0,
                        floor=1e-3, bm=bm, scale=scale)
    checks.check_topk(vals, idx, pv, pi, s64, bound)
    checks.check_sums(sums, s64, exponent=1.0, floor=1e-3, v=v)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_split_sweep_matches_unsplit(card, precision):
    """A sweep with too few CTAs for the card splits its columns: counts and
    top-k equal an unsplit launch's, and both launches' walk sums lie within
    1e-6 of f64 (the chain's prefix launch at a small size: exponent 0.5, a
    per-row scale, sums at exponent 1)."""
    a, b, rs1, rs2 = _inputs(card, 256, 9000, 64, precision, seed=10)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits = cuda_lib.column_splits(256, 9000, sms, cuda_lib.tile_rows(256, 256))
    assert splits > 1
    scale = torch.from_numpy(
        np.random.default_rng(11).random(256).astype(np.float32) ** 0.5).to(card)
    v = torch.from_numpy((10.0 ** np.random.default_rng(12).uniform(-1, 1, 9000))
                         .astype(np.float32)).to(card)
    kw = dict(n_bins=1024, exponent=0.5, rs_exponent=1.0, floor=1e-3, k=32, bm=256,
              precision=precision, rs1=rs1, rs2=rs2)
    ka, kb = kernel_operand(a, precision), kernel_operand(b, precision)
    split = sim_sweep_cuda(ka, kb, scale, v, **kw)
    whole = sim_sweep_cuda(ka, kb, scale, v, splits=1, **kw)
    torch.cuda.synchronize()
    for x, y in zip(split[:3], whole[:3]):
        assert torch.equal(x, y)
    s64, _ = checks.exact_scores(a, b, precision, rs1, rs2)
    for sums in (split[3], whole[3]):
        checks.check_sums(sums, s64, exponent=1.0, floor=1e-3, v=v)


def test_tile_shared_memory(card):
    """The sweep at k 32 and 4,096 bins: the 128 x 128 tile fits one CTA an
    SM (227 KB a block), the 64 x 64 tile two (228 KB an SM, 1 KB reserved
    a CTA); a k = 128 top-k launch takes the 64 tile, as the wrapper
    narrows a tile whose shared memory does not fit."""
    smem = cuda_lib.lib().repro_sim_smem_bytes
    sweep = cuda_lib.HIST | cuda_lib.TOPK | cuda_lib.SUMS
    assert smem(sweep, 4096, 32, 128) == 227328
    assert 2 * (smem(sweep, 4096, 32, 64) + 1024) <= 233472
    assert smem(cuda_lib.TOPK, 1, 128, 64) <= cuda_lib.MAX_SMEM < smem(cuda_lib.TOPK, 1, 128, 128)
    # the few-row top-k: its scores' 4-stage ring of 32 + 256 rows and
    # top-digit counts, and its selection's histogram copies, list and
    # 16,384 kept keys
    few = cuda_lib.lib().repro_topk_few_rows_smem_bytes
    assert few(0) == 4 * 288 * 144 + 32 * 256 * 4 <= cuda_lib.MAX_SMEM
    assert few(1) == 256 * 32 * 4 + (1024 + 16384) * 8 <= cuda_lib.MAX_SMEM


def test_launch_checks_raise(card):
    a, b, _, _ = _inputs(card, 64, 64, 16, "fp32")
    with pytest.raises(ValueError):
        sim_topk_cuda(kernel_operand(a, "fp32").double(), kernel_operand(b, "fp32"), k=4)
    with pytest.raises(ValueError):  # k beyond the columns
        sim_topk_cuda(kernel_operand(a, "fp32"), kernel_operand(b, "fp32"), k=65)


def test_query_on_card_matches_cpu(card):
    from repro_torch.core import Agg, Query, run_bas_streaming
    from repro_torch.data import make_clustered_tables

    ds = make_clustered_tables(300, 280, n_entities=120, noise=0.4, seed=5)
    res = {}
    for dev in ("cpu", "cuda"):
        cuda_lib.reset_launches()
        q = Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(), budget=1500)
        res[dev] = run_bas_streaming(q, seed=0, device=dev)
        if dev == "cuda":
            assert cuda_lib.LAUNCHES["sim_sweep[fp32]"] == 1
        else:
            assert sum(cuda_lib.LAUNCHES.values()) == 0
    a, b = res["cpu"], res["cuda"]
    assert a.telemetry.stratify is not None
    assert b.estimate == pytest.approx(a.estimate, rel=1e-6)
    assert b.ci.lo == pytest.approx(a.ci.lo, rel=1e-6)
    assert b.ci.hi == pytest.approx(a.ci.hi, rel=1e-6)


# ---------------------------------------------------------------------------
# K8: the bootstrap-t's resamples on the card
# ---------------------------------------------------------------------------

# strata of 2, 1,000 and 20,000 samples (AVG's 20,000 x 16 B exceed a
# CTA's shared memory and are read from L2; COUNT's and SUM's 160 KB fit)
BOOT_SIZES = (2, 1000, 20000, 2, 37)
BOOT_ROWS = {"SUM": [0, 2], "COUNT": [1, 3], "AVG": [0, 1, 2, 3, 4]}


def _boot_strata(sizes, seed=3):
    from repro_torch.core.estimators import StratumSample

    rng = np.random.default_rng(seed)
    return [StratumSample(o=(rng.random(n) < 0.4).astype(float), g=rng.lognormal(1.0, 0.7, n),
                          q=rng.dirichlet(np.ones(n)) + 1e-6, size=20 * n) for n in sizes]


def _boot_terms(samples):
    usable = [s for s in samples if s.n > 1]
    return ([s.sum_terms() - s.sum_terms().mean() for s in usable],
            [s.count_terms() - s.count_terms().mean() for s in usable])


def _card_moments(card, st, ct, agg, n_boot, rng):
    from repro_torch.core import bootstrap
    from repro_torch.core.types import Agg

    return np.array(bootstrap._moments_card(st, ct, Agg[agg], n_boot, rng, card))


def _assert_moments_close(got, want, rows):
    """The rows the aggregate reads within 1e-10 of each row's largest
    (the card sums in another order than numpy); the rest 0."""
    scale = np.abs(want[rows]).max(axis=1, keepdims=True)
    assert (np.abs(got[rows] - want[rows]) <= 1e-10 * scale).all()
    assert not got[[r for r in range(5) if r not in rows]].any()


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG"])
def test_bootstrap_kernel_matches_numpy(card, agg):
    """The card's draws are the Generator's: its moments match the numpy
    path's from the same seed, the Generator ends where numpy leaves it,
    a second run is bit for bit, and the CI is the numpy path's within
    1e-9 relative."""
    from repro_torch.core import bootstrap
    from repro_torch.core.estimators import BlockedRegime
    from repro_torch.core.types import Agg

    samples = _boot_strata(BOOT_SIZES)
    st, ct = _boot_terms(samples)
    host_rng, card_rng = np.random.default_rng(9), np.random.default_rng(9)
    for r in (host_rng, card_rng):
        r.integers(0, 5, 1)  # a half-word buffered on entry
    want = np.array(bootstrap._moments_host(st, ct, 1000, host_rng))
    before = card_rng.bit_generator.state
    got = _card_moments(card, st, ct, agg, 1000, card_rng)
    assert card_rng.bit_generator.state == host_rng.bit_generator.state
    _assert_moments_close(got, want, BOOT_ROWS[agg])
    again = np.random.default_rng()
    again.bit_generator.state = before
    np.testing.assert_array_equal(_card_moments(card, st, ct, agg, 1000, again), got)
    blocked = BlockedRegime(o=np.ones(4), g=np.full(4, 2.0))
    est_h, ci_h = bootstrap.bootstrap_t_ci(samples, blocked, Agg[agg], 0.95, 1000,
                                           np.random.default_rng(21))
    est_c, ci_c = bootstrap.bootstrap_t_ci(samples, blocked, Agg[agg], 0.95, 1000,
                                           np.random.default_rng(21), device=card)
    assert est_c == est_h
    assert abs(ci_c.lo - ci_h.lo) <= 1e-9 * abs(ci_h.lo)
    assert abs(ci_c.hi - ci_h.hi) <= 1e-9 * abs(ci_h.hi)


@pytest.mark.parametrize("slack", [None, 0])
def test_bootstrap_kernel_resolves_many_rejections(card, monkeypatch, slack):
    """A stratum of 1.5e6 samples rejects about 1e-4 of its words: some
    1,600 rejections in 10 resamples.  With no slack, the detecting kernel's
    list and word range both run short and are raised."""
    from repro_torch.core import bootstrap
    from repro_torch.kernels import plain

    if slack is not None:
        monkeypatch.setattr(plain, "rejection_slack", lambda highs, counts: slack)
    samples = _boot_strata((1_500_000, 3))
    st, ct = _boot_terms(samples)
    host_rng, card_rng = np.random.default_rng(5), np.random.default_rng(5)
    want = np.array(bootstrap._moments_host(st, ct, 10, host_rng))
    cuda_lib.reset_launches()
    got = _card_moments(card, st, ct, "COUNT", 10, card_rng)
    assert card_rng.bit_generator.state == host_rng.bit_generator.state
    _assert_moments_close(got, want, BOOT_ROWS["COUNT"])
    assert cuda_lib.LAUNCHES["bootstrap_detect"] == (1 if slack is None else 3)
    assert cuda_lib.LAUNCHES["bootstrap_moments"] == 1


def test_bootstrap_threads_do_not_wait_on_the_default_stream(card):
    """Two threads' bootstraps, each on its own stream, finish while a long
    kernel still holds the default stream, with the results of a serial
    run."""
    import threading

    samples = _boot_strata((1000, 500, 2000))
    st, ct = _boot_terms(samples)
    serial = [_card_moments(card, st, ct, "AVG", 1000, np.random.default_rng(s))
              for s in (1, 2)]
    got, errors = {}, []
    start = threading.Barrier(3)

    def client(seed):
        try:
            _card_moments(card, st, ct, "AVG", 1000, np.random.default_rng(seed))  # warm
            start.wait(timeout=60)
            start.wait(timeout=60)
            got[seed] = _card_moments(card, st, ct, "AVG", 1000, np.random.default_rng(seed))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
            start.abort()

    threads = [threading.Thread(target=client, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    start.wait(timeout=60)      # both warm
    torch.cuda._sleep(4_000_000_000)  # about 2 s of the default stream
    held = torch.cuda.Event()
    held.record()
    start.wait(timeout=60)
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    still_held = not held.query()
    torch.cuda.synchronize()
    assert not errors, errors
    assert still_held
    for i, s in enumerate((1, 2)):
        np.testing.assert_array_equal(got[s], serial[i])


def test_query_on_card_counts_its_bootstrap_draws(card):
    from repro_torch.core import Agg, Query, run_bas_streaming
    from repro_torch.data import make_clustered_tables

    ds = make_clustered_tables(300, 280, n_entities=120, noise=0.4, seed=5)
    cuda_lib.reset_launches()
    res = run_bas_streaming(Query(spec=ds.spec(), agg=Agg.AVG, oracle=ds.oracle(), budget=1500),
                            seed=0, device=card)
    c = res.telemetry.counters
    assert c["ci.draws_device"] > 0 and "ci.draws_host" not in c
    assert cuda_lib.LAUNCHES["bootstrap_moments"] == 1


# ---------------------------------------------------------------------------
# the persistent stratification index on the card
# ---------------------------------------------------------------------------

def _index_artifacts_equal(got, want):
    """Key, sizes, counts, every count tile and the valid top-k bit for
    bit (tiles regrouped where ``got`` keeps a finer stride); walk sums
    within 1e-6 relative."""
    from repro_torch.core.index import _regroup_tiles

    assert (got.key, got.sizes) == (want.key, want.sizes)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(
        _regroup_tiles(got.block_counts, got.block_rows, want.block_rows),
        want.block_counts)
    ok = np.asarray(want.topk_valid)
    np.testing.assert_array_equal(got.topk_valid, ok)
    np.testing.assert_array_equal(np.asarray(got.topk_vals)[ok],
                                  np.asarray(want.topk_vals)[ok])
    np.testing.assert_array_equal(np.asarray(got.topk_idx)[ok],
                                  np.asarray(want.topk_idx)[ok])
    if want.row_sums is not None:
        np.testing.assert_allclose(got.row_sums[0], want.row_sums[0], rtol=1e-6)
        assert got.total_weight == pytest.approx(want.total_weight, rel=1e-6)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("table", [0, 1])
def test_index_append_on_card_equals_rebuild(card, precision, table):
    """Left and right appends on the card equal a rebuild on the card bit
    for bit in tiles and top-k: each score is the same number in the delta
    launch as in the rebuild's (one fmaf chain in fp32, a fixed k-slice
    order in bf16, exact integer sums in int8)."""
    from repro_torch.core import append_rows, build_index

    rng = np.random.default_rng(20 + table)
    e1, e2 = _unit(rng, 900, 64), _unit(rng, 700, 64)
    n1, n2 = (700, 700) if table == 0 else (900, 500)
    kw = dict(n_bins=1024, precision=precision, tolerance=float("inf"),
              device="cuda")
    art = build_index([e1[:n1], e2[:n2]], **kw)
    assert art.precision == precision and art.kernel
    grown = append_rows(art, table, (e1[n1:], e2[n2:])[table], device="cuda")
    _index_artifacts_equal(grown, build_index([e1, e2], **kw))


def test_index_small_tiles_on_card_equal_plain(card):
    """An artifact built on 32 left rows keeps 32-row count tiles; after a
    left append to 300 rows, the right append sweeps every left row at that
    stride, one launch a tile.  The card's artifact equals a rebuild on the
    card, and the CPU's appends under the edge, near-tie and 1e-6 rules."""
    from repro_torch.core import append_rows, build_index

    rng = np.random.default_rng(23)
    e1, e2 = _unit(rng, 300, 48), _unit(rng, 640, 48)
    grown = {}
    for dev in ("cuda", "cpu"):
        art = build_index([e1[:32], e2[:500]], n_bins=512, device=dev)
        assert art.block_rows == 32
        cuda_lib.reset_launches()
        art = append_rows(append_rows(art, 0, e1[32:], device=dev), 1, e2[500:],
                          device=dev)
        if dev == "cuda":
            # 9 chunks of the left append, one launch a 32-row tile after
            assert cuda_lib.LAUNCHES["sim_sweep[fp32]"] == 9 + 10
        grown[dev] = art
    _index_artifacts_equal(grown["cuda"], build_index([e1, e2], n_bins=512,
                                                      device="cuda"))
    a, b = torch.from_numpy(e1).to(card), torch.from_numpy(e2).to(card)
    s64, bound = checks.exact_scores(a, b)
    c, p = grown["cuda"], grown["cpu"]
    checks.check_counts([torch.from_numpy(c.block_counts), torch.from_numpy(p.block_counts)],
                        s64, bound, n_bins=512, exponent=1.0, floor=1e-3, bm=32)
    checks.check_topk(*(torch.from_numpy(np.asarray(x)) for x in (
        c.topk_vals, c.topk_idx, p.topk_vals, p.topk_idx)), s64, bound)
    checks.check_sums(torch.from_numpy(c.row_sums[0]), s64, exponent=1.0, floor=1e-3)


def test_hydrated_query_on_card_equals_fresh(card, tmp_path):
    """A query hydrated from an artifact (resident, and mmap-loaded from
    disk) equals the fresh query on the card bit for bit, and launches no
    sweep; concurrent first queries share one build."""
    import threading

    from repro_torch.checkpoint.index_io import load_index, save_index
    from repro_torch.core import Agg, IndexStore, Query, build_index, run_bas_streaming
    from repro_torch.data import make_clustered_tables

    ds = make_clustered_tables(600, 500, n_entities=200, noise=0.4, seed=5)

    def q():
        return Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(), budget=2000)

    fresh = run_bas_streaming(q(), seed=0)
    art = build_index([ds.emb1, ds.emb2])
    save_index(str(tmp_path), art)
    for a in (art, load_index(str(tmp_path), art.key)):
        cuda_lib.reset_launches()
        res = run_bas_streaming(q(), seed=0, artifact=a)
        assert not any(k.startswith("sim_sweep") for k in cuda_lib.LAUNCHES)
        assert (res.estimate, res.ci.lo, res.ci.hi) == (
            fresh.estimate, fresh.ci.lo, fresh.ci.hi)
    store = IndexStore()
    cuda_lib.reset_launches()
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        run_bas_streaming(q(), seed=0, index_store=store))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 3 and cuda_lib.LAUNCHES["sim_sweep[fp32]"] == 1
    assert store.stats()["index_build"] == 1
    for res in out:
        assert res.estimate == fresh.estimate


# ---------------------------------------------------------------------------
# the model-stack kernels: K5 flash attention, K6 RWKV6 scan, K7 RG-LRU scan
# ---------------------------------------------------------------------------

def _normal(card, rng, shape, dtype=torch.float32, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(card, dtype)


# (B, Hq, Hkv, Sq, Skv, d, causal, window): MHA, GQA and MQA; lengths that
# are not multiples of the 64-row tiles; windows; Sq < Skv; rows whose keys
# the window masks entirely (Sq > Skv, not causal); d from 16 to 256
FLASH_SHAPES = [
    (2, 12, 12, 48, 48, 64, True, 0),
    (3, 4, 4, 16, 16, 64, True, 0),
    (1, 8, 2, 130, 130, 64, True, 0),
    (2, 16, 1, 100, 100, 256, True, 40),
    (1, 16, 1, 300, 300, 256, True, 128),
    (1, 4, 1, 70, 200, 32, True, 0),
    (2, 4, 2, 33, 33, 16, False, 0),
    (1, 2, 1, 90, 90, 128, False, 17),
    (1, 2, 1, 90, 40, 16, False, 10),
    # the model families' shapes (chip_smoke.py FLASH_SHAPES): olmoe's MHA
    # and qwen3's 16:1 GQA at d 128, pixtral's 256 patches + 48 tokens,
    # whisper's encoder over 1,500 frames and its cross-attention (48
    # queries over 1,500 keys), neither causal; batches cut
    (8, 16, 16, 48, 48, 128, True, 0),
    (8, 64, 4, 48, 48, 128, True, 0),
    (1, 32, 8, 304, 304, 128, True, 0),
    (1, 16, 16, 1500, 1500, 64, False, 0),
    (2, 16, 16, 48, 1500, 64, False, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_SHAPES)
def test_flash_attention_matches_plain(card, dtype, b, hq, hkv, sq, skv, d,
                                       causal, window):
    rng = np.random.default_rng(sq * 7 + d)
    q = _normal(card, rng, (b, hq, sq, d), dtype)
    k = _normal(card, rng, (b, hkv, skv, d), dtype)
    v = _normal(card, rng, (b, hkv, skv, d), dtype)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    checks.check_model_kernel(
        got, flash_attention_ref(q, k, v, causal=causal, window=window),
        checks.flash_attention_bound(q, k, v, causal=causal, window=window))


# bf16 on the tensor cores at the scorer's buckets (S 16, 32, 48): MHA, GQA
# and MQA at d 64 and 256, and ragged Skv (not a multiple of 16)
BF16_SHORT = [(s, d, hq, hkv) for s in (16, 32, 48) for d in (64, 256)
              for hq, hkv in ((4, 4), (8, 2), (6, 1))]


@pytest.mark.parametrize("sq,skv,d,hq,hkv,causal,window",
                         [(s, s, d, hq, hkv, True, 0) for s, d, hq, hkv in BF16_SHORT]
                         + [(37, 37, 64, 4, 4, True, 0), (20, 37, 64, 8, 2, True, 0),
                            (45, 45, 256, 16, 1, True, 2048), (37, 37, 256, 3, 3, False, 9)])
def test_flash_attention_bf16_short_sequences(card, sq, skv, d, hq, hkv, causal, window):
    rng = np.random.default_rng(sq * 13 + d + hq)
    q = _normal(card, rng, (3, hq, sq, d), torch.bfloat16)
    k = _normal(card, rng, (3, hkv, skv, d), torch.bfloat16)
    v = _normal(card, rng, (3, hkv, skv, d), torch.bfloat16)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    checks.check_model_kernel(
        got, flash_attention_ref(q, k, v, causal=causal, window=window),
        checks.flash_attention_bound(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("sq", [16, 32, 64, 45])
def test_flash_attention_bf16_latent_widths(card, sq):
    """Latent attention's (192, 128): q and k 192 wide, v and the output
    128, causal, bf16, at the scorer's batch of 256 and its buckets (and a
    ragged 45), 16 heads, against the plain version; counted apart."""
    rng = np.random.default_rng(sq + 192)
    q = _normal(card, rng, (256, 16, sq, 192), torch.bfloat16)
    k = _normal(card, rng, (256, 16, sq, 192), torch.bfloat16)
    v = _normal(card, rng, (256, 16, sq, 128), torch.bfloat16)
    cuda_lib.reset_launches()
    got = flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (256, 16, sq, 128)
    assert dict(cuda_lib.LAUNCHES) == {"flash_attention_192_128": 1}
    checks.check_model_kernel(
        got, flash_attention_ref(q, k, v, causal=True),
        checks.flash_attention_bound(q, k, v, causal=True))
    with pytest.raises(ValueError):
        flash_attention_cuda(q.float(), k.float(), v.float())


@pytest.mark.parametrize("b,h,t,hd", [(2, 3, 48, 64), (1, 2, 300, 64),
                                      (2, 2, 333, 16), (1, 1, 70, 128),
                                      (1, 4, 9, 32)])
def test_rwkv6_scan_matches_plain(card, b, h, t, hd):
    rng = np.random.default_rng(t + hd)
    r, k, v = (_normal(card, rng, (b, h, t, hd), scale=0.5) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.9, 0.999, (b, h, t, hd)).astype(np.float32)).to(card)
    u = _normal(card, rng, (h, hd), scale=0.1)
    got = rwkv6_scan_cuda(r, k, v, w, u)
    torch.cuda.synchronize()
    checks.check_model_kernel(got, rwkv6_scan_ref(r, k, v, w, u),
                              checks.rwkv6_scan_bound(r, k, v, w, u))


def _rwkv_model_layout(card, rng, b, h, t, hd, dtype):
    """r, k, v in ``dtype`` and w f32 laid out (B, T, H, hd) as the model's
    projections are, returned as the (B, H, T, hd) views it passes; u (H,
    hd)."""
    r, k, v = (_normal(card, rng, (b, t, h, hd), dtype, scale=0.5).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.from_numpy(
        rng.uniform(-8.0, -1.0, (b, t, h, hd)).astype(np.float32)).to(card))).transpose(1, 2)
    return r, k, v, w, _normal(card, rng, (h, hd), scale=0.1)


def _check_rwkv6(card, xs, split):
    from repro_torch.kernels.rwkv6_scan.kernel import column_split

    r = xs[0]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert column_split(r.shape[0] * r.shape[1], r.shape[3], sms) == split
    got = rwkv6_scan_cuda(*xs)
    torch.cuda.synchronize()
    # r is a (B, T, H, hd) tensor seen as (B, H, T, hd): so is the output
    assert got.dtype == torch.float32 and got.transpose(1, 2).is_contiguous()
    return checks.check_model_kernel(got, rwkv6_scan_ref(*xs), checks.rwkv6_scan_bound(*xs))


# (B, H): 768 heads take the per-head layout on an H100 (132 SMs), 8 the
# column split
RWKV_HEADS = {False: (24, 32), True: (2, 4)}


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_rwkv6_scan_model_layout_bf16(card, hd, split):
    """bf16 r, k, v and f32 w read through the strides of the model's (B, T,
    H, hd) projections; the output comes back in r's layout."""
    b, h = RWKV_HEADS[split]
    xs = _rwkv_model_layout(card, np.random.default_rng(hd), b, h, 48, hd, torch.bfloat16)
    _check_rwkv6(card, xs, split)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("t", [23, 48, 100])
def test_rwkv6_scan_ragged_steps(card, t, split):
    """T not a multiple of the 8-step chunk at hd 64 (the last chunk's
    steps past T are zero-filled and skipped)."""
    b, h = RWKV_HEADS[split]
    xs = _rwkv_model_layout(card, np.random.default_rng(t), b, h, t, 64, torch.bfloat16)
    _check_rwkv6(card, xs, split)


def test_rwkv6_scan_long_sequence_splits_columns(card):
    """B 1, T 4096: 32 heads take the column split (8 warps a head)."""
    xs = _rwkv_model_layout(card, np.random.default_rng(4096), 1, 32, 4096, 64,
                            torch.bfloat16)
    _check_rwkv6(card, xs, True)


def test_rwkv6_scan_refuses_unaligned_layouts(card):
    x = torch.zeros(1, 2, 8, 72, device=card, dtype=torch.bfloat16)
    ok = torch.zeros(1, 2, 8, 64, device=card)
    u = torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="16-byte"):  # starts 8 bytes in
        rwkv6_scan_cuda(x[..., 4:68], x[..., 8:72], x[..., 8:72], ok, u)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        rwkv6_scan_cuda(ok, ok, ok, torch.zeros(1, 2, 64, 8, device=card).transpose(2, 3), u)
    with pytest.raises(ValueError, match="bfloat16"):  # r, k, v of one type
        rwkv6_scan_cuda(ok.bfloat16(), ok, ok.bfloat16(), ok, u)


@pytest.mark.parametrize("b,t,r", [(4, 48, 4096), (1, 1000, 100), (3, 7, 65)])
def test_rglru_scan_matches_plain(card, b, t, r):
    rng = np.random.default_rng(t + r)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (b, t, r)).astype(np.float32)).to(card)
    g = _normal(card, rng, (b, t, r))
    got = rglru_scan_cuda(a, g)
    torch.cuda.synchronize()
    checks.check_model_kernel(got, rglru_scan_ref(a, g), checks.rglru_scan_bound(a, g))


def test_model_kernel_launch_checks_raise(card):
    x = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_cuda(x, x, x)
    y = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(y.transpose(1, 2), y.transpose(1, 2), y.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan_cuda(y.double(), y, y, y, torch.zeros(2, 64, device=card))
    a = torch.zeros(1, 8, 16, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        rglru_scan_cuda(a, a)


def _family_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.num_patches:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch,over,kernels", [
    ("joinml-oracle", {}, {"flash_attention"}),
    ("rwkv6-1.6b", {}, {"rwkv6_scan"}),
    ("recurrentgemma-9b", {"num_layers": 5}, {"rglru_scan", "flash_attention"}),
    ("olmoe-1b-7b", {}, {"flash_attention"}),
    ("qwen3-moe-235b-a22b", {}, {"flash_attention"}),
    ("whisper-medium", {}, {"flash_attention"}),
    ("pixtral-12b", {}, {"flash_attention"}),
])
def test_forward_on_card_matches_cpu(card, arch, over, kernels):
    """The reduced models at f32: the card's forward (through the kernels)
    against the CPU's (through their plain versions); whisper with its
    frames, pixtral with its patches."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import forward, init_params

    cfg = get_smoke_config(arch, dtype="float32", **over)
    params = init_params(cfg, seed=1, device="cpu")
    batch = _family_batch(cfg, 3, 45, seed=2)
    want = forward(cfg, params, batch)
    cuda_lib.reset_launches()
    got = forward(cfg, copy.deepcopy(params).to(card), batch)
    torch.cuda.synchronize()
    assert {k for k, n in cuda_lib.LAUNCHES.items() if n} == kernels
    err = float((got.cpu() - want).abs().max())
    assert err <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch,over", [
    ("olmoe-1b-7b", {}), ("rwkv6-1.6b", {}), ("recurrentgemma-9b", {"num_layers": 5}),
    ("whisper-medium", {}), ("pixtral-12b", {}),
])
def test_decode_on_card_matches_cpu(card, arch, over):
    """The reduced models at f32: eight decode steps on the card (the
    carried states, ring buffers and cross-attention in plain torch there
    too) against the same steps on the CPU, within 2e-5 of the largest
    |logit|."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_cache, init_params

    cfg = get_smoke_config(arch, dtype="float32", **over)
    params = init_params(cfg, seed=1, device="cpu")
    on_card = copy.deepcopy(params).to(card)
    tokens = _family_batch(cfg, 3, 8, seed=3)["tokens"]
    cpu_cache = init_cache(cfg, 3, 8, device="cpu")
    card_cache = init_cache(cfg, 3, 8, device=card)
    for t in range(8):
        want, cpu_cache = decode_step(cfg, params, cpu_cache, tokens[:, t:t + 1], t)
        got, card_cache = decode_step(cfg, on_card, card_cache, tokens[:, t:t + 1], t)
        assert float((got.cpu() - want).abs().max()) <= 2e-5 * float(want.abs().max())


# ----------------------------------------------------------------------------
# the serving plane with the Oracle model on the card
# ----------------------------------------------------------------------------

def _card_oracle_setup(card, n=48):
    """The reduced joinml-oracle (bf16, seed 0) behind a ``PairScorer`` on
    the card over ``n`` x ``n`` synthetic records, the join spec and the
    threshold that says yes to the top 10% of P(match)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_clustered_tables
    from repro_torch.data.pipeline import ByteTokenizer, pair_example
    from repro_torch.models import init_params
    from repro_torch.serve import PairScorer

    tok = ByteTokenizer()
    cfg = get_smoke_config("joinml-oracle", vocab_size=tok.vocab_size)
    records = [f"entity {i % 12} record {i:03d}" for i in range(n)]

    def tok_pair(pair):
        t, _ = pair_example(tok, records[pair[0]], records[pair[1]], None, 48)
        return t[t != tok.PAD]

    scorer = PairScorer(cfg, init_params(cfg, seed=0, device=card), tok_pair,
                        tok.YES, tok.NO, max_len=48, batch_size=32,
                        device=card)
    ds = make_clustered_tables(n, n, n_entities=32, noise=0.4, seed=0)
    pairs = np.stack(np.unravel_index(np.arange(n * n), (n, n)), 1)
    thr = float(np.quantile(scorer.score(pairs), 0.9))
    return scorer, ds, thr


def test_served_equals_serial_with_the_oracle_on_the_card(card):
    """Four BAS COUNT queries through one ``OracleService`` with a shared
    label store, their Oracle the reduced joinml-oracle on the card: each
    query's estimate, CI and ``calls`` equal its serial run bit for bit (the
    scorer pads every forward to one batch shape), and the summed charge
    equals the store's unique misses."""
    from repro_torch.core import Agg, ModelOracle, Query, run_bas
    from repro_torch.serve import LabelStore, OracleService, serve_queries

    scorer, ds, thr = _card_oracle_setup(card)
    seeds = (0, 1, 2, 3)

    def query():
        return Query(spec=ds.spec(), agg=Agg.COUNT, budget=600,
                     oracle=ModelOracle(scorer, thr, name="joinml-oracle"))

    serial = []
    for s in seeds:
        q = query()
        serial.append((run_bas(q, seed=s, device=card), q.oracle.calls))
    store = LabelStore()
    queries = [query() for _ in seeds]
    with OracleService(workers=1, max_wait_ms=60_000.0,
                       label_store=store) as svc:
        svc.attach(*[q.oracle for q in queries])

        def job(q, s):
            try:
                return run_bas(q, seed=s, device=card)
            finally:
                svc.detach(q.oracle)

        results = serve_queries(
            svc, [lambda q=q, s=s: job(q, s) for q, s in zip(queries, seeds)],
            timeout=300.0)
        stats = svc.stats()
    for (ref, calls), got, q in zip(serial, results, queries):
        assert got.estimate == ref.estimate
        assert got.ci.lo == ref.ci.lo and got.ci.hi == ref.ci.hi
        assert q.oracle.calls == calls
    assert sum(q.oracle.charged for q in queries) == stats["store_misses"]
    assert stats["windows"] < stats["segments"]


def test_loopback_server_with_the_oracle_on_the_card(card):
    """A BAS query labelling through a loopback ``OracleServiceServer`` whose
    group is the card's scorer equals the same query labelling in process:
    estimate, CI and ledger."""
    from repro_torch.core import Agg, ModelOracle, Query, run_bas
    from repro_torch.serve import OracleServiceServer, RemoteOracle, scorer_group

    scorer, ds, thr = _card_oracle_setup(card)
    local = ModelOracle(scorer, thr)
    ref = run_bas(Query(spec=ds.spec(), agg=Agg.COUNT, oracle=local,
                        budget=600), seed=5, device=card)
    with OracleServiceServer({"oracle": scorer_group(scorer, thr)},
                             max_wait_ms=60_000.0) as srv:
        with RemoteOracle(srv.address, "oracle", timeout_s=120.0,
                          retries=0) as remote:
            got = run_bas(Query(spec=ds.spec(), agg=Agg.COUNT, oracle=remote,
                                budget=600), seed=5, device=card)
        stats = srv.service.stats()
    assert got.estimate == ref.estimate
    assert got.ci.lo == ref.ci.lo and got.ci.hi == ref.ci.hi
    assert (remote.calls, remote.requests) == (local.calls, local.requests)
    assert stats["rows_labelled"] == local.calls


# ---------------------------------------------------------------------------
# K5's backward, training on the card, and the launch autotuner
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, d, causal, window): chip_smoke.py's phase 3c shapes
# cut in batch, then each head width
FLASH_BWD_SHAPES = [
    (2, 12, 12, 128, 128, 64, True, 0),     # the training shape
    (2, 64, 4, 48, 48, 128, True, 0),       # GQA 16:1 at d 128
    (1, 16, 1, 300, 300, 256, True, 128),   # a window under MQA
    (1, 4, 4, 300, 300, 64, False, 0),      # not causal
    (1, 4, 4, 112, 300, 64, False, 0),      # cross-attention
    (3, 4, 2, 100, 100, 32, True, 0),       # a ragged Sq
    (1, 2, 1, 40, 10, 16, False, 5),        # rows whose keys are all masked
    (2, 16, 1, 128, 128, 256, True, 2048),  # recurrentgemma's training MQA, batch cut
] + [(2, 4, 2, 70, 70, d, True, 0) for d in (16, 32, 64, 128, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_BWD_SHAPES)
def test_flash_attention_backward_matches_f64(card, dtype, b, hq, hkv, sq, skv, d,
                                              causal, window):
    """dQ, dK and dV within ``checks.flash_attention_grad_bound`` of an f64
    autograd of the plain version, the same bits twice, and the autograd
    op (its forward saves the lse) giving the same gradients."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda

    gen = torch.Generator(device=card).manual_seed(sq + d)
    q, do = (torch.randn((b, hq, sq, d), generator=gen, device=card).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=card).to(dtype)
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
    assert torch.equal(o, flash_attention_cuda(q, k, v, causal, window))
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal, window)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal, window)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_ref(qd, kd, vd, causal, window),
                               (qd, kd, vd), do.double())
    for g, w, e in zip(got, want,
                       checks.flash_attention_grad_bound(q, k, v, do, causal, window)):
        assert g.dtype == dtype
        checks.check_model_kernel(g, w, e)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(flash_attention(qa, ka, va, causal, window), (qa, ka, va), do)
    assert all(torch.equal(x, y) for x, y in zip(auto, got))


def test_flash_attention_backward_refuses_other_head_widths(card):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda

    q = torch.zeros((1, 1, 4, 48), device=card)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_bwd_cuda(q, q, q, q, q, torch.zeros((1, 1, 4), device=card))


# ---------------------------------------------------------------------------
# K6's and K7's backwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,r", [(4, 48, 4096), (1, 1000, 100), (3, 7, 65), (2, 1, 40)])
def test_rglru_scan_backward_matches_f64(card, b, t, r):
    """da and dg within ``checks.rglru_scan_grad_bound`` of an f64 autograd
    of the plain version, the same bits twice, and the autograd op giving
    the same gradients."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd_cuda

    rng = np.random.default_rng(t + r)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (b, t, r)).astype(np.float32)).to(card)
    g, do = _normal(card, rng, (b, t, r)), _normal(card, rng, (b, t, r))
    h = rglru_scan_cuda(a, g)
    got = rglru_scan_bwd_cuda(a, h, do)
    again = rglru_scan_bwd_cuda(a, h, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ad, gd = (x.double().requires_grad_() for x in (a, g))
    want = torch.autograd.grad(rglru_scan_ref(ad, gd), (ad, gd), do.double())
    for x, y, e in zip(got, want, checks.rglru_scan_grad_bound(a, g, do)):
        checks.check_model_kernel(x, y, e)
    aa, ga = (x.clone().requires_grad_() for x in (a, g))
    auto = torch.autograd.grad(rglru_scan(aa, ga), (aa, ga), do)
    assert all(torch.equal(x, y) for x, y in zip(auto, got))


def _rwkv6_backward(card, xs, do):
    """K6's backward on ``xs`` against an f64 autograd of the plain version
    under ``checks.rwkv6_scan_grad_bound``, twice bit for bit, and through
    the autograd op; returns the largest ratio of error to tolerance."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_cuda

    got = rwkv6_scan_bwd_cuda(*xs, do)
    again = rwkv6_scan_bwd_cuda(*xs, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for x, ref in zip(got, xs):
        assert x.dtype == ref.dtype and x.shape == ref.shape
    xd = [x.double().requires_grad_() for x in xs]
    # at T 1 the last step's w reaches no output: its gradient is 0
    want = torch.autograd.grad(rwkv6_scan_ref(*xd), xd, do.double(), materialize_grads=True)
    ratio = max(checks.check_model_kernel(x, y, e)["err_over_tol"] for x, y, e in
                zip(got, want, checks.rwkv6_scan_grad_bound(*xs, do)))
    xa = [x.detach().clone().requires_grad_() for x in xs]
    auto = torch.autograd.grad(rwkv6_scan(*xa), xa, do)
    assert all(torch.equal(x, y) for x, y in zip(auto, got))
    return ratio


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 23, 40])
def test_rwkv6_scan_backward_model_layout_bf16(card, hd, t):
    """bf16 r, k, v and f32 w as views of (B, T, H, hd) projections, the
    cotangent in the output's layout; T 1, ragged and several chunks."""
    rng = np.random.default_rng(hd * 100 + t)
    xs = _rwkv_model_layout(card, rng, 2, 3, t, hd, torch.bfloat16)
    do = _normal(card, rng, (2, t, 3, hd)).transpose(1, 2)
    _rwkv6_backward(card, xs, do)


@pytest.mark.parametrize("hd", [64, 128])
def test_rwkv6_scan_backward_cluster_at_few_heads(card, hd):
    """Few heads (B 1, H 4): each head's cluster spans its full hd / 16
    CTAs, whose row sums meet through distributed shared memory, over 38
    chunks with a ragged last one; bf16 in the model's layout."""
    from repro_torch.kernels.rwkv6_scan.kernel import bwd_plan

    assert bwd_plan(hd).cluster == hd // 16
    rng = np.random.default_rng(hd + 300)
    xs = _rwkv_model_layout(card, rng, 1, 4, 300, hd, torch.bfloat16)
    do = _normal(card, rng, (1, 300, 4, hd)).transpose(1, 2)
    _rwkv6_backward(card, xs, do)


@pytest.mark.parametrize("b,h,t,hd", [(2, 3, 48, 64), (1, 2, 300, 64), (1, 1, 70, 128),
                                      (3, 2, 33, 16)])
def test_rwkv6_scan_backward_f32(card, b, h, t, hd):
    rng = np.random.default_rng(t + hd)
    r, k, v = (_normal(card, rng, (b, h, t, hd), scale=0.5) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.9, 0.999, (b, h, t, hd)).astype(np.float32)).to(card)
    u = _normal(card, rng, (h, hd), scale=0.1)
    _rwkv6_backward(card, (r, k, v, w, u), _normal(card, rng, (b, h, t, hd)))


def test_scan_backwards_refuse_what_they_do_not_take(card):
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd_cuda
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_cuda

    x = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head width"):
        rwkv6_scan_bwd_cuda(x, x, x, x, torch.zeros(2, 48, device=card), x)
    y = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan_bwd_cuda(y, y, y, y, torch.zeros(2, 64, device=card), y.bfloat16())
    a = torch.zeros(1, 8, 16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_bwd_cuda(a, a, torch.zeros(1, 16, 8, device=card).transpose(1, 2))


def test_train_step_on_card_matches_cpu(card):
    """One f32 train step of joinml-oracle (remat on) on the card against
    the CPU from the same parameters: loss and gradients within 1e-4 of
    each leaf's largest |g| (tests/test_torch_train.py's rule)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train import loss_and_grads

    cfg = dataclasses.replace(get_smoke_config("joinml-oracle", dtype="float32"), remat=True)
    cpu = init_params(cfg, 0, device="cpu")
    gpu = init_params(cfg, 0, device=card)
    with torch.no_grad():
        for (_, a), b in zip(cpu.named_parameters(), gpu.parameters()):
            b.copy_(a)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 40))}
    before = dict(cuda_lib.LAUNCHES)
    lg, gg = loss_and_grads(cfg, gpu, batch)
    launched = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()}
    lc, gc = loss_and_grads(cfg, cpu, batch)
    assert launched["flash_attention"] == 2 * cfg.num_layers    # remat runs it twice
    assert launched["flash_attention_bwd"] == cfg.num_layers
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for name, g in gc.items():
        np.testing.assert_allclose(gg[name].cpu().numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * float(g.abs().max()), err_msg=name)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_tuned_launch_keeps_tiles_and_lists(card, precision, tmp_path):
    """Every candidate the tuner may choose against the default launch:
    equal count tiles and top-k lists, walk sums within 1e-6 relative."""
    from repro_torch.kernels import autotune

    m, n, d, k = 640, 3000, 48, 16
    a, b, rs1, rs2 = _inputs(card, m, n, d, precision)
    a, b = kernel_operand(a, precision), kernel_operand(b, precision)
    rng = np.random.default_rng(2)
    scale = torch.from_numpy(rng.random(m).astype(np.float32)).to(card)
    v = torch.from_numpy((10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)).to(card)
    flags = cuda_lib.HIST | cuda_lib.TOPK | cuda_lib.SUMS
    kw = dict(rs1=rs1, rs2=rs2, scale=scale, v=v, n_bins=256, k=k, bm=128)
    bc0, v0, i0, s0 = cuda_lib._launch_tile(precision, flags, a, b, **kw)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    cands = autotune.candidates("sim_sweep", m, n, d, precision, card)
    assert cands
    for rows, factor in cands:
        splits = autotune.apply_split(m, n, sms, rows, factor)
        bc, vals, idx, sums = cuda_lib._launch_tile(precision, flags, a, b, rows=rows,
                                                    splits=splits, **kw)
        torch.cuda.synchronize()
        assert torch.equal(bc, bc0) and torch.equal(vals, v0) and torch.equal(idx, i0)
        rel = ((sums.double() - s0.double()).abs() / s0.double().abs()).max()
        assert float(rel) <= 1e-6
    autotune.reset()
    try:
        autotune.configure(tmp_path / "autotune.json")
        won = autotune.schedule("sim_sweep", m, n, d, precision, card)
        assert won in cands and (tmp_path / "autotune.json").exists()
        bc, vals, idx, _ = cuda_lib._launch_tile(precision, flags, a, b, **kw)
        assert torch.equal(bc, bc0) and torch.equal(vals, v0) and torch.equal(idx, i0)
    finally:
        autotune.reset()


@pytest.mark.parametrize("arch,kernels", [
    ("rwkv6-1.6b", {"rwkv6_scan": 2, "rwkv6_scan_bwd": 1}),
    ("recurrentgemma-9b", {"rglru_scan": 2, "rglru_scan_bwd": 1,
                           "flash_attention": 2, "flash_attention_bwd": 1}),
])
def test_recurrent_train_step_on_card_matches_cpu(card, arch, kernels):
    """One f32 train step of the reduced recurrent models (remat on) on the
    card, through K6 or K7 and their backward kernels (and K5 for
    recurrentgemma's attention layer), against the CPU from the same
    parameters: loss and gradients within 1e-4 of each leaf's largest |g|
    (tests/test_torch_train.py's rule); launches a layer of each kind."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train import loss_and_grads

    cfg = dataclasses.replace(get_smoke_config(arch, dtype="float32"), remat=True)
    cpu = init_params(cfg, 0, device="cpu")
    gpu = init_params(cfg, 0, device=card)
    with torch.no_grad():
        for (_, a), b in zip(cpu.named_parameters(), gpu.parameters()):
            b.copy_(a)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 40))}
    before = dict(cuda_lib.LAUNCHES)
    lg, gg = loss_and_grads(cfg, gpu, batch)
    launched = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
                if v - before.get(k, 0)}
    lc, gc = loss_and_grads(cfg, cpu, batch)
    kinds = cfg.layer_types()
    layers = {"rwkv6_scan": kinds.count("rwkv"), "rglru_scan": kinds.count("rec"),
              "flash_attention": kinds.count("attn")}
    assert launched == {name: n * layers[name.replace("_bwd", "")]
                        for name, n in kernels.items()}
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for name, g in gc.items():
        np.testing.assert_allclose(gg[name].cpu().numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * float(g.abs().max()), err_msg=name)
