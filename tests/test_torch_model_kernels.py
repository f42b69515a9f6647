"""The plain PyTorch versions of the model-stack kernels (K5 flash attention,
K6 the RWKV6 scan, K7 the RG-LRU scan) against the reference's jnp
references and its Pallas kernels in interpret mode, on the same
numpy-seeded inputs.

Tolerances: at f32 both sides compute the same function in f32 with sums in
another order, so outputs agree within 2e-6 absolute for attention (whose
outputs are convex combinations of O(1) values) and within 1e-5 relative
plus 1e-6 absolute for the scans, whose states are sums over time.  With
bf16 inputs both compute in f32 and round once to bf16, so they agree
within one bf16 ulp of the output (2**-7 relative).

The rule the kernels are held to on the card (``checks.check_model_kernel``
with the ``checks.*_bound`` error bounds) is checked here too: the plain f32
versions lie within the bound of an f64 evaluation, and an output off by
more than the rule allows is refused.

K6's CUDA kernel evaluates the recurrence in its own order: the bonus term
hoisted into one scalar a step (``beta_t = sum_i (r_i u_i) k_i``, summed by a
warp butterfly), the read-out in NP partial sums a column and RG row groups
that meet by a butterfly; each state element takes a multiply and two FMAs.
:func:`emulate_rwkv6_kernel` repeats that order in f32 (an FMA as one f64
operation rounded to f32, which can differ from a true FMA in the last bit,
well inside the bound) for the per-head and the column-split layouts, and is
held to ``checks.rwkv6_scan_bound`` against the f64 recurrence and to twice
that bound against the Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_rwkv6
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_rwkv6_ref
from repro_torch.kernels import checks
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.kernel import HEAD_WARPS, column_split, rwkv6_scan_cuda

BF16_ULP = 2.0**-7


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(rng, shape, dtype):
    """The same values as a jnp array and a torch tensor of one type."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        return jx, torch.from_numpy(_np(jx)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, dtype, atol):
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=BF16_ULP * 1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ----------------------------------------------------------------------------
# K5: flash attention
# ----------------------------------------------------------------------------

# (B, Hq, Hkv, S, d, causal, window, dtype, Pallas block): MHA, GQA, MQA,
# ragged lengths (not a multiple of 16), a window, d in {16, 64}
FLASH_CASES = [
    (2, 4, 4, 32, 16, True, 0, "float32", 16),
    (2, 4, 2, 24, 16, True, 0, "float32", 8),
    (1, 4, 1, 40, 64, True, 0, "float32", 8),
    (1, 2, 1, 48, 16, True, 16, "float32", 16),
    (2, 4, 2, 20, 64, False, 0, "float32", 4),
    (1, 3, 1, 36, 16, False, 7, "float32", 12),
    (2, 4, 2, 24, 64, True, 8, "bfloat16", 8),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,dtype,blk", FLASH_CASES)
def test_flash_plain_matches_reference_and_pallas(b, hq, hkv, s, d, causal,
                                                  window, dtype, blk):
    rng = np.random.default_rng(s * 31 + d)
    jq, q = _pair(rng, (b, hq, s, d), dtype)
    jk, k = _pair(rng, (b, hkv, s, d), dtype)
    jv, v = _pair(rng, (b, hkv, s, d), dtype)
    got = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = _np(jax_flash_ref(jq, jk, jv, causal=causal, window=window))
    _close(got, want, dtype, atol=2e-6)
    pallas = _np(flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                        bq=blk, bkv=blk, interpret=True))
    _close(got, pallas, dtype, atol=2e-6)


def test_flash_op_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 10, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 10, 16)).astype(np.float32))
    assert torch.equal(flash_attention(q, k, k, window=4),
                       flash_attention_ref(q, k, k, window=4))


# ----------------------------------------------------------------------------
# K6: RWKV6 scan
# ----------------------------------------------------------------------------

def _rwkv_inputs(rng, b, h, t, hd):
    r, k, v = (rng.standard_normal((b, h, t, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, (b, h, t, hd)).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,h,t,hd", [(2, 2, 16, 16), (1, 3, 23, 16), (1, 2, 12, 64)])
def test_rwkv6_plain_matches_reference_and_pallas(b, h, t, hd):
    xs = _rwkv_inputs(np.random.default_rng(t + hd), b, h, t, hd)
    got = rwkv6_scan(*(torch.from_numpy(x) for x in xs)).numpy()
    assert got.dtype == np.float32 and got.shape == (b, h, t, hd)
    jx = [jnp.asarray(x) for x in xs]
    for want in (jax_rwkv6_ref(*jx), jax_rwkv6(*jx, ct=8, interpret=True)):
        np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)


def test_rwkv6_op_reads_the_model_layout_on_cpu():
    """The op as the model calls it, on bf16 (B, T, H, hd) projections seen
    as (B, H, T, hd) with f32 decays, equals the reference-layout call on
    their f32 copies exactly (the plain version widens as the kernel does)."""
    rng = np.random.default_rng(3)
    b, t, h, hd = 2, 13, 3, 16
    r, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, hd)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.8, 0.999, (b, t, h, hd)).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((h, hd)) * 0.1).astype(np.float32))
    got = rwkv6_scan(*(z.transpose(1, 2) for z in (r, k, v, w)), u)
    want = rwkv6_scan(*(z.float().transpose(1, 2).contiguous() for z in (r, k, v, w)), u)
    assert got.dtype == torch.float32 and got.shape == (b, h, t, hd)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------------
# K6: the kernel's evaluation order and layout policy
# ----------------------------------------------------------------------------

def _fma(a, b, c):
    """a * b + c rounded once to f32 (a * b of two f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _beta(r, k, u, ct):
    """beta_t = sum_i (r_i u_i) k_i of each step as the kernel's warp sums it:
    lane l takes rows l, l + 32, ..., then per chunk of ``ct`` steps a
    butterfly that halves the steps a lane carries at each level, then sums
    the lanes that share a step.  r, k: (B, H, T, hd); u: (H, hd)."""
    b, h, t, hd = r.shape
    lanes = torch.arange(32)
    out = torch.empty((b, h, t))
    for t0 in range(0, t, ct):
        n = min(ct, t - t0)
        part = torch.zeros((32, ct, b, h))
        for m in range(-(-hd // 32)):
            for ln in range(32):
                i = ln + 32 * m
                if i < hd:
                    ru = (r[:, :, t0:t0 + n, i] * u[None, :, None, i]).permute(2, 0, 1)
                    part[ln, :n] = _fma(ru, k[:, :, t0:t0 + n, i].permute(2, 0, 1),
                                        part[ln, :n])
        step = torch.zeros(32, dtype=torch.long)
        for lvl in range(5):
            o, half = 16 >> lvl, (ct >> lvl) // 2
            up = (lanes & o) != 0
            if half:
                new = part.clone()
                for j in range(half):
                    send = torch.where(up[:, None, None], part[:, j], part[:, j + half])
                    keep = torch.where(up[:, None, None], part[:, j + half], part[:, j])
                    new[:, j] = keep + send[lanes ^ o]
                part = new
                step += up.long() * half
            else:
                part[:, 0] = part[:, 0] + part[lanes ^ o, 0]
        for ln in range(32):
            if step[ln] < n:
                out[:, :, t0 + step[ln]] = part[ln, 0]
    return out


def emulate_rwkv6_kernel(r, k, v, w, u, rg, np_, ct):
    """The kernel's arithmetic for a layout of ``rg`` row groups, ``np_``
    partial sums a column and chunks of ``ct`` steps: (B, H, T, hd) f32."""
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    b, h, t, hd = r.shape
    rpl = hd // rg
    beta = _beta(r, k, u, ct)
    s = torch.zeros((b, h, hd, hd))  # S[i, j]
    outs = []
    for step in range(t):
        rt, kt, vt, wt = (x[:, :, step] for x in (r, k, v, w))  # (B, H, hd)
        groups = []
        for g in range(rg):
            acc = [torch.zeros((b, h, hd)) for _ in range(np_)]
            for i in range(g * rpl, (g + 1) * rpl):
                e = (i - g * rpl) % np_
                acc[e] = _fma(rt[:, :, i, None].expand(b, h, hd), s[:, :, i], acc[e])
            groups.append((acc[0] + acc[1]) + (acc[2] + acc[3]) if np_ == 4
                          else acc[0] + acc[1])
        while len(groups) > 1:  # the row groups' butterfly
            groups = [groups[2 * j] + groups[2 * j + 1] for j in range(len(groups) // 2)]
        outs.append(_fma(vt, beta[:, :, step, None].expand(b, h, hd), groups[0]))
        kv = kt[:, :, :, None] * vt[:, :, None, :]  # f32 multiply
        s = _fma(wt[:, :, :, None].expand_as(s), s, kv)
    return torch.stack(outs, dim=2)


# (row groups, partial sums, chunk steps) of csrc/model_kernels.cu's
# rw_dispatch: the per-head layout and the column split
RWKV_LAYOUTS = {16: {"per head": (2, 4, 32), "column split": (4, 4, 32)},
                64: {"per head": (2, 2, 8), "column split": (4, 4, 32)}}


@pytest.mark.parametrize("layout", ["per head", "column split"])
@pytest.mark.parametrize("b,h,t,hd", [(2, 2, 16, 16), (1, 3, 23, 16), (1, 2, 12, 64)])
def test_rwkv6_kernel_order_holds_the_bound(b, h, t, hd, layout):
    xs = _rwkv_inputs(np.random.default_rng(t + hd), b, h, t, hd)
    tx = [torch.from_numpy(x) for x in xs]
    rg, np_, ct = RWKV_LAYOUTS[hd][layout]
    got = emulate_rwkv6_kernel(*tx, rg=rg, np_=np_, ct=ct)
    bound = checks.rwkv6_scan_bound(*tx)
    err = (got.double() - _rwkv6_f64(*tx)).abs()
    assert (err <= bound).all(), float((err / bound).max())
    pallas = jax_rwkv6(*(jnp.asarray(x) for x in xs), ct=8, interpret=True)
    checks.check_model_kernel(got, torch.from_numpy(np.array(pallas)), bound)


@pytest.mark.parametrize("heads,hd,split", [
    (256 * 32, 64, False),   # the rwkv6-1.6b path: B 256, H 32
    (1 * 32, 64, True),      # B 1, T 4096: 32 heads
    (24 * 32, 128, False),   # 768 heads at hd 128: 4 warps a head
    (8, 16, True),           # a test's few heads
])
def test_rwkv6_column_split_policy(heads, hd, split):
    """The column split takes over where the per-head layout would give an
    H100 (132 SMs) fewer than 4 warps an SM."""
    assert column_split(heads, hd, 132) == split
    assert (heads * HEAD_WARPS[hd] < 4 * 132) == split


# ----------------------------------------------------------------------------
# K7: RG-LRU scan
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,r,dtype", [(2, 24, 64, "float32"), (1, 37, 48, "float32"),
                                         (2, 16, 256, "bfloat16")])
def test_rglru_plain_matches_reference_and_pallas(b, t, r, dtype):
    rng = np.random.default_rng(t * r)
    a = rng.uniform(0.5, 0.999, (b, t, r)).astype(np.float32)
    g = rng.standard_normal((b, t, r)).astype(np.float32)
    if dtype == "bfloat16":
        ja, jg = jnp.asarray(a, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
        ta = torch.from_numpy(_np(ja)).to(torch.bfloat16)
        tg = torch.from_numpy(_np(jg)).to(torch.bfloat16)
    else:
        ja, jg, ta, tg = jnp.asarray(a), jnp.asarray(g), torch.from_numpy(a), torch.from_numpy(g)
    got = rglru_scan(ta, tg)
    assert got.dtype == torch.float32 and got.shape == (b, t, r)
    for want in (jax_rglru_ref(ja, jg), jax_rglru(ja, jg, ct=8, br=16, interpret=True)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# the comparison rule: f32 error bounds against f64 evaluations
# ----------------------------------------------------------------------------

def _attention_f64(q, k, v, causal, window):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = lambda x: x.double().repeat_interleave(hq // hkv, dim=1)  # noqa: E731
    s = q.double() @ rep(k).transpose(-1, -2) * d**-0.5
    qp, kp = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask = qp >= kp
    if window > 0:
        mask = mask & (qp - kp < window)
    # a row masked whole has every score at -1e30: it averages v
    empty = ~mask.any(-1, keepdim=True)
    s = torch.where(mask, s, -torch.inf).masked_fill(empty, 0.0)
    return torch.softmax(s, -1) @ rep(v)


def _rwkv6_f64(r, k, v, w, u):
    r, k, v, w, u = (x.double() for x in (r, k, v, w, u))
    s = torch.zeros(r.shape[:2] + (r.shape[3], r.shape[3]), dtype=torch.float64)
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], s + u[None, :, :, None] * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(outs, dim=2)


def _rglru_f64(a, g):
    h, hs = torch.zeros_like(a[:, 0].double()), []
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + g[:, t].double()
        hs.append(h)
    return torch.stack(hs, dim=1)


# (B, Hq, Hkv, Sq, Skv, d, causal, window, scale of q and k): ragged tiles,
# several KV tiles, GQA and MQA, rows the window masks whole (Sq > Skv, not
# causal), and large scores
BOUND_CASES = [
    (2, 4, 2, 48, 48, 64, True, 0, 1.0),
    (1, 2, 1, 150, 150, 16, True, 40, 1.0),
    (1, 2, 1, 90, 40, 16, False, 10, 1.0),
    (1, 4, 4, 70, 70, 32, False, 0, 3.0),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,sc", BOUND_CASES)
def test_flash_bound_holds_for_the_plain_version(b, hq, hkv, sq, skv, d, causal,
                                                 window, sc):
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy((rng.standard_normal((b, h, n, d)) * f).astype(np.float32))
               for h, n, f in ((hq, sq, sc), (hkv, skv, sc), (hkv, skv, 1.0)))
    bound = checks.flash_attention_bound(q, k, v, causal=causal, window=window)
    exact = _attention_f64(q, k, v, causal, window)
    err = (flash_attention_ref(q, k, v, causal=causal, window=window).double() - exact).abs()
    assert (err <= bound).all()
    assert float(bound.max()) < 1e-4 * sc * sc * float(v.abs().max())
    res = checks.check_model_kernel(flash_attention_ref(q, k, v, causal=causal, window=window),
                                    exact.float(), bound)
    assert res["err_over_tol"] <= 0.5


@pytest.mark.parametrize("kind", ["rwkv6", "rglru"])
def test_scan_bound_holds_for_the_plain_version(kind):
    rng = np.random.default_rng(11)
    if kind == "rwkv6":
        xs = [torch.from_numpy(x) for x in _rwkv_inputs(rng, 2, 2, 300, 32)]
        got, exact = rwkv6_scan(*xs), _rwkv6_f64(*xs)
        bound = checks.rwkv6_scan_bound(*xs)
    else:
        a = torch.from_numpy(rng.uniform(0.5, 0.9999, (2, 500, 64)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((2, 500, 64)).astype(np.float32))
        got, exact, bound = rglru_scan(a, g), _rglru_f64(a, g), checks.rglru_scan_bound(a, g)
    err = (got.double() - exact).abs()
    assert (err <= bound).all()
    # the bound is gamma(n_t) of the magnitudes: here at most about 1e-4
    # of the largest |out| (measured: 1.4e-4 for RWKV6, 6.7e-5 for RG-LRU)
    assert float(bound.max()) < 1e-3 * float(exact.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_model_kernel_refuses_an_error_past_the_rule(dtype):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (1, 64, 32)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32))
    want, bound = rglru_scan(a, g), checks.rglru_scan_bound(a, g)
    res = checks.check_model_kernel(want.to(dtype), want.to(dtype), bound)
    assert res["max_abs_err"] == 0 and res["err_over_tol"] == 0
    assert res["max_tolerance"] >= 2 * float(bound.max())
    got = want.clone()
    slack = 2 * bound[0, 40, 7] + (checks.BF16_ULP * 1.1 * want[0, 40, 7].abs()
                                   if dtype == torch.bfloat16 else 0)
    got[0, 40, 7] += float(slack) * 1.5 + 1e-3
    with pytest.raises(AssertionError, match="beyond the bound"):
        checks.check_model_kernel(got.to(dtype), want.to(dtype), bound)


# ----------------------------------------------------------------------------
# the launch wrappers take CUDA tensors only: no quiet fallback
# ----------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rwkv6_scan_cuda(x, x, x, x, torch.zeros(2, 16))
    a = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rglru_scan_cuda(a, a)
