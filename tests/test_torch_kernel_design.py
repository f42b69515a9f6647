"""The arithmetic and launch policy of the redesigned kernels, on the CPU.

* **K5 at bf16** runs on the tensor cores: q . k as bf16 products summed in
  f32 (the products of two bf16 are exact in f32), the online softmax over
  64-key tiles, and P . V with each f32 weight split exactly into three bf16
  terms, each multiplied by V (exact in bf16) and summed in f32.
  :func:`emulate_flash_bf16` repeats that arithmetic in plain PyTorch, and
  it is held to ``checks.check_model_kernel`` (twice the f32 error bound of
  attention plus half a bf16 ulp each side, the rule the card's kernel
  meets) against ``flash_attention_ref`` at every ``chip_smoke.FLASH_SHAPES``
  entry at a batch of 2, and against the reference's Pallas kernel in
  interpret mode at a small shape.  The S 4096 shapes keep their batch,
  heads and lengths; their check runs one (batch, q head) at a time for the
  first and the last q head, so that the f64 bound's (S, S) temporaries
  stay near 1 GB (every head computes alike).
* **K1 at bf16** runs its product on the tensor cores: each 64-column ring
  slice accumulates into a zeroed fragment that is added to the running
  f32 sum with round-to-nearest.  :func:`emulate_bf16_scores` truncates
  (rounds toward zero) after every product inside a slice, the worst
  rounding an mma could do, and its scores stay inside
  ``checks.exact_scores``' bf16 bound.
* **The similarity tile** is 128 x 128 where a launch's count tiles hold
  whole 128-row tiles, else 64 x 64, and a launch with fewer CTA rows than
  SMs splits its columns into ranges of whole column tiles, enough for
  about four CTAs per SM
  (``cuda_lib.tile_rows``, ``cuda_lib.column_splits``).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels import checks, cuda_lib
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TILE = checks.FA_TILE


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def split3(p):
    """f32 ``p`` as three bf16 terms whose f32 sum is ``p`` exactly."""
    hi = p.to(torch.bfloat16).float()
    mid = (p - hi).to(torch.bfloat16).float()
    lo = (p - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def emulate_flash_bf16(q, k, v, causal=True, window=0):
    """The bf16 tensor-core kernel's arithmetic: (B, Hq, Sq, d) bf16 out."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    m = torch.full((b, hkv, g, sq, 1), -1e30)
    l = torch.zeros((b, hkv, g, sq, 1))
    acc = torch.zeros((b, hkv, g, sq, d))
    qp = torch.arange(sq)[:, None]
    for kv0 in range(0, skv, TILE):
        kp = torch.arange(kv0, min(kv0 + TILE, skv))[None, :]
        s = (qf @ kf[..., kv0:kv0 + TILE, :].transpose(-1, -2)) * d**-0.5
        masked = torch.zeros((sq, kp.shape[1]), dtype=torch.bool)
        if causal:
            masked |= qp < kp
        if window > 0:
            masked |= qp - kp >= window
        s = torch.where(masked, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[..., kv0:kv0 + TILE, :]
        pv = torch.zeros_like(acc)
        for term in reversed(split3(p)):  # the smallest term first
            pv = pv + term @ vt
        acc = acc * alpha + pv
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.reshape(b, hq, sq, d).to(torch.bfloat16)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def test_split3_is_exact():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.concatenate([
        rng.random(4096), np.exp(-rng.uniform(0, 60, 4096)), [0.0, 1.0, 2.0**-100]
    ]).astype(np.float32))
    hi, mid, lo = split3(p)
    assert torch.equal(hi + mid + lo, p)
    assert torch.equal((hi + mid) + lo, p)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)


@pytest.mark.parametrize("label", ["joinml-oracle path", "recurrentgemma-9b path",
                                   "olmoe-1b-7b path", "qwen3-moe heads path",
                                   "pixtral-12b, 256 patches + 48 tokens",
                                   "whisper-medium encoder",
                                   "whisper-medium cross-attention",
                                   "joinml-oracle, 16-token bucket"])
def test_flash_bf16_emulation_holds_the_rule_at_path_shapes(label):
    _, hq, hkv, sq, skv, d, causal, window = _chip_smoke().FLASH_SHAPES[label]
    rng = np.random.default_rng(sq + d)
    q = _bf16(rng, (2, hq, sq, d))
    k, v = (_bf16(rng, (2, hkv, skv, d)) for _ in range(2))
    got = emulate_flash_bf16(q, k, v, causal, window)
    res = checks.check_model_kernel(
        got, flash_attention_ref(q, k, v, causal=causal, window=window),
        checks.flash_attention_bound(q, k, v, causal=causal, window=window))
    assert res["err_over_tol"] <= 1.0


@pytest.mark.parametrize("label", ["llama3.2-1b heads, S 4096",
                                   "recurrentgemma heads, S 4096, window 2048"])
def test_flash_bf16_emulation_holds_the_rule_at_long_shapes(label):
    _, hq, hkv, s, skv, d, causal, window = _chip_smoke().FLASH_SHAPES[label]
    rng = np.random.default_rng(s + d)
    q, k, v = (_bf16(rng, (2, h, s, d)) for h in (hq, hkv, hkv))
    for h in (0, hq - 1):
        kvh = h // (hq // hkv)
        for bi in range(2):
            qh = q[bi:bi + 1, h:h + 1]
            kh, vh = k[bi:bi + 1, kvh:kvh + 1], v[bi:bi + 1, kvh:kvh + 1]
            got = emulate_flash_bf16(qh, kh, vh, causal, window)
            checks.check_model_kernel(
                got, flash_attention_ref(qh, kh, vh, causal=causal, window=window),
                checks.flash_attention_bound(qh, kh, vh, causal=causal, window=window))


def test_flash_bf16_emulation_matches_pallas():
    """Against the reference's Pallas kernel in interpret mode (f32 P . V),
    GQA, a ragged length and a window, at the rule the card is held to."""
    b, hq, hkv, s, d, window = 2, 4, 2, 40, 16, 24
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    q, k, v = (torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)
               for x in jx)
    pallas = flash_attention_pallas(*jx, causal=True, window=window, bq=8, bkv=8,
                                    interpret=True)
    pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32))).to(torch.bfloat16)
    got = emulate_flash_bf16(q, k, v, True, window)
    checks.check_model_kernel(got, pallas,
                              checks.flash_attention_bound(q, k, v, window=window))


# ----------------------------------------------------------------------------
# the similarity tile's launch policy
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,bm,rows", [
    (32768, 256, 128),   # the main path's sweep: count tiles of 256 rows
    (4096, 256, 128),    # the chain's prefix block
    (300, 64, 64),       # count tiles of 64 rows
    (300, 192, 64),      # 192 is a multiple of 64, not of 128
    (300, 300, 128),     # one count tile (the histogram launch: bm = M)
    (300, 512, 128),     # one count tile, bm past M
    (64, 64, 64),        # one narrow tile's rows
    (8, 8, 64),          # the raised-k retry's few rows
])
def test_tile_rows(m, bm, rows):
    assert cuda_lib.tile_rows(m, bm) == rows
    # a CTA's rows always fall in one count tile
    assert bm >= m or bm % rows == 0


@pytest.mark.parametrize("rows", [cuda_lib.CTA_ROWS, cuda_lib.WIDE_ROWS])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_column_splits_are_ranges_the_kernel_accepts(rows, sms):
    for m in (1, 8, 64, 65, 300, 4096, 32768):
        for n in (1, 63, 64, 1000, 5000, 32768, 100000):
            s = cuda_lib.column_splits(m, n, sms, rows)
            tiles = -(-n // rows)  # square tiles
            per = -(-tiles // s)
            assert 1 <= s <= min(tiles, cuda_lib.MAX_SPLITS)
            assert -(-tiles // per) == s  # repro_sim_launch's own check
            ctas = -(-m // rows)
            if ctas >= sms:
                assert s == 1


def test_chain_prefix_launch_fills_the_card():
    """The 3-way chain's 4,096-row prefix block against 32,768 columns: 32
    CTAs of 128 rows, split into column ranges for about 4 CTAs per SM of an
    H100 (132 SMs)."""
    rows = cuda_lib.tile_rows(4096, 256)
    splits = cuda_lib.column_splits(4096, 32768, 132, rows)
    assert rows == 128 and splits == 16  # 256 column tiles, 16 a range
    assert -(-4096 // rows) * splits >= 2 * 132
    # the main path's sweep has 256 CTAs of 128 rows: no split
    assert cuda_lib.column_splits(32768, 32768, 132, 128) == 1



# ----------------------------------------------------------------------------
# K1 at bf16: the accumulation schedule on the tensor cores
# ----------------------------------------------------------------------------

def _round_toward_zero(x64):
    f = x64.float()
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def emulate_bf16_scores(a, b, slice_cols=64):
    """Row-wise dot products of bf16 ``a`` and ``b`` (n, d) as the bf16
    product accumulates them: within a slice of ``slice_cols`` columns every
    product is added with truncation (the worst an mma may round), and each
    slice's sum is added to the running f32 score with round-to-nearest."""
    af, bf = a.float(), b.float()
    acc = torch.zeros(a.shape[0])
    for c0 in range(0, a.shape[1], slice_cols):
        part = torch.zeros(a.shape[0])
        for c in range(c0, min(c0 + slice_cols, a.shape[1])):
            part = _round_toward_zero(part.double() + (af[:, c] * bf[:, c]).double())
        acc = acc + part
    return acc


def test_bf16_tensor_core_schedule_holds_the_bound():
    """At d 384 on 4,096 seeded pairs of unit rows (and their sign-flipped
    halves, so scores cancel), the truncating schedule stays inside the
    bound ``checks.exact_scores`` holds a bf16 score to."""
    rng = np.random.default_rng(21)
    e = rng.standard_normal((2, 4096, 384)).astype(np.float32)
    e /= np.linalg.norm(e, axis=2, keepdims=True)
    e[1, 2048:] = -e[0, 2048:] + 0.01 * e[1, 2048:]   # near-cancelling pairs
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in e)
    got = emulate_bf16_scores(a, b).double()
    exact = (a.double() * b.double()).sum(1)
    d = a.shape[1]
    gamma = d * checks.U / (1 - d * checks.U)
    bound = gamma * (a.double() * b.double()).abs().sum(1) + 1e-30
    ratio = float(((got - exact).abs() / bound).max())
    print(f"bf16 schedule: worst |score - exact| / bound = {ratio:.4f}")
    assert ratio <= 1.0
    # the schedule's own estimate, (2 * 64 + d / 64) u sum |a b|, is about a
    # third of gamma_384
    assert ratio <= (2 * 64 + d / 64) / d


# ----------------------------------------------------------------------------
# K3 over few rows: the selection of fewrow_select, step by step
# ----------------------------------------------------------------------------

def _choose(hist, need):
    """The digit where the count from the top reaches ``need``: (digit,
    keys above it, keys in it)."""
    above = 0
    for b in range(255, -1, -1):
        if above + hist[b] >= need:
            return b, above, int(hist[b])
        above += int(hist[b])
    raise AssertionError("fewer keys than k")


def emulate_fewrow_select(scores, k, seed=0):
    """What ``fewrow_scores`` and ``fewrow_select`` do with a row block's
    f32 scores: clip (keeping a -0.0, as ``fmaxf`` may), map each clipped
    score to its key (the float's bits, -0.0 taken to +0.0), count the keys
    by their top 8 bits (the scores kernel's histogram), and take the
    column into a 64-bit key ``key << 32 | ~column``.  Radix passes of 8
    bits from the top, each taking the digit where the count from the top
    reaches k, until the chosen bin holds exactly the keys still needed (the
    column's bits above those N - 1 needs are skipped): the first from the
    histogram; then one read of the keys puts those above the chosen top
    digit in the list and keeps those of the digit; the later passes count
    the kept keys that match the digits so far.  The kept keys at or above
    the threshold join the list (in an arbitrary order, as atomics give
    them), and each key goes to its place, the number of keys above it.
    Returns (vals (M, k) f32, idx (M, k) int32, passes a row)."""
    m, n = scores.shape
    s32 = np.asarray(scores, np.float32)
    clipped = np.where(s32 < 0, np.float32(0), np.where(s32 > 1, np.float32(1), s32))
    u = clipped.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    top = [np.bincount(row >> 24, minlength=256) for row in u]
    cbits = ((n - 1).bit_length() + 7) & ~7 if n > 1 else 0
    lo = np.uint64(0xFFFFFFFF) - np.arange(n, dtype=np.uint64)
    full = (1 << 64) - 1
    rng = np.random.default_rng(seed)
    vals = np.empty((m, k), np.float32)
    idx = np.empty((m, k), np.int32)
    passes = []
    for r in range(m):
        x = (u[r].astype(np.uint64) << np.uint64(32)) | lo
        prefix = (0xFFFFFFFF << cbits) & 0xFFFFFFFF if cbits < 32 else 0
        b1, above, in_bin = _choose(top[r], k)
        prefix |= b1 << 56
        need = k - above
        done = in_bin == need
        d1 = x >> np.uint64(56)
        got = [x[d1 > b1]]
        kept = x[d1 == b1]
        npass = 1
        if done:
            got.append(kept)
        else:
            s = 48
            while True:
                mask = (full << (s + 8)) & full
                match = ((kept ^ np.uint64(prefix)) & np.uint64(mask)) == 0
                hist = np.bincount(((kept[match] >> np.uint64(s)) & np.uint64(0xFF))
                                   .astype(np.int64), minlength=256)
                npass += 1
                b, above, in_bin = _choose(hist, need)
                prefix |= b << s
                need -= above
                nxt = s - 8 if s > 32 else (cbits - 8 if s == 32 else s - 8)
                if in_bin == need or nxt < 0:
                    break
                s = nxt
            got.append(kept[kept >= np.uint64(prefix)])
        lst = rng.permutation(np.concatenate(got))
        assert len(lst) == k
        place = (lst[None, :] > lst[:, None]).sum(axis=1)
        srt = np.empty_like(lst)
        srt[place] = lst
        vals[r] = (srt >> np.uint64(32)).astype(np.uint32).view(np.float32)
        idx[r] = (np.uint64(0xFFFFFFFF) - (srt & np.uint64(0xFFFFFFFF))).astype(np.int32)
        passes.append(npass)
    return vals, idx, passes


def _adversarial(case):
    """(scores (M, N) f32, k) of one adversarial case."""
    rng = np.random.default_rng(31)
    if case == "every score clipped to 0":
        return -rng.random((3, 3000)).astype(np.float32) - 0.01, 128
    if case == "exact duplicates straddling the k-th value":
        levels = np.float32([0.9, 0.7, 0.7001, 0.5, 0.2, 0.0])
        return levels[rng.integers(0, len(levels), (4, 2000))], 128
    if case == "a -0.0 score":
        s = rng.uniform(-1.0, 1.0, (3, 1000)).astype(np.float32)
        s[:, 900:] = 0.0
        s[:, 300:340] = -0.0
        s[:, ::7] = -0.0
        return s, 600
    if case == "k = N":
        return rng.integers(-2, 5, (3, 300)).astype(np.float32) / 4, 300
    assert case == "k = 128 on N = 5,000"
    return rng.uniform(-0.2, 1.2, (8, 5000)).astype(np.float32), 128


@pytest.mark.parametrize("case", ["every score clipped to 0",
                                  "exact duplicates straddling the k-th value",
                                  "a -0.0 score", "k = N", "k = 128 on N = 5,000"])
def test_fewrow_select_emulation_matches_plain_topk(case):
    """The emulated selection equals ``sim_topk_ref`` bit for bit on
    adversarial rows (its scores made exact by an identity E2, so the plain
    version sees the same floats).  Zeros compare by value: the key takes
    -0.0 to +0.0, and the plain version's clamp may keep either sign, so
    the plain values' zeros are taken to +0.0 before the bits are
    compared."""
    from repro_torch.kernels.sim_topk.ref import sim_topk_ref

    scores, k = _adversarial(case)
    m, n = scores.shape
    ev, ei, passes = emulate_fewrow_select(scores, k)
    pv, pi = sim_topk_ref(torch.from_numpy(scores), torch.eye(n), k=k)
    assert np.array_equal(ei, pi.numpy())
    assert np.array_equal(ev.view(np.int32), (pv + 0.0).numpy().view(np.int32))
    if case == "every score clipped to 0":
        # every value digit ties: the passes go on into the column's bits
        # (N - 1 needs 12, rounded up to 16: two passes) and take the
        # lowest columns
        assert passes == [6] * m and (ei == np.arange(k)).all()
    if case == "a -0.0 score":
        assert (np.signbit(scores) & (scores == 0)).any()
        assert (ev == 0).any()


@pytest.mark.parametrize("mode,flags,m,few", [
    ("fp32", cuda_lib.TOPK, 1, True),
    ("fp32", cuda_lib.TOPK, 8, True),     # the raised-k retry's rows
    ("fp32", cuda_lib.TOPK, 32, True),
    ("fp32", cuda_lib.TOPK, 33, False),   # just above the cut
    ("bf16", cuda_lib.TOPK, 8, False),    # bf16 top-k keeps the tile kernel
    ("fp32", cuda_lib.HIST | cuda_lib.TOPK | cuda_lib.SUMS, 8, False),
])
def test_few_row_kernel_is_chosen_by_shape(mode, flags, m, few):
    assert cuda_lib.few_rows(mode, flags, m) == few
    assert cuda_lib.FEW_ROWS == 32
