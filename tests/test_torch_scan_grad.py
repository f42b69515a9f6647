"""The backwards of the two recurrent scans on the CPU: K6's (RWKV6) and
K7's (RG-LRU) plain backward recurrences, their error bounds and their
autograd ops, against PyTorch's autograd of the plain forwards and against
``jax.vjp`` of the reference's scans, at small shapes from seeded numpy
inputs (RWKV6's r, k, v and w as (B, H, T, hd) views of (B, T, H, hd)
projections, as the model passes them).

Tolerances: in f64 the backward recurrences equal autograd of the forward
within 1e-10 (the same sums in other orders); in f32 each gradient lies
within ``checks.*_scan_grad_bound`` of the f64 one (the bound of one f32
evaluation), and ours and JAX's f32 vjp within twice it plus half a bf16 ulp
each side for a bf16 gradient (``checks.check_model_kernel``, the rule the
card's kernels meet)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_rwkv6
from repro_torch.kernels import checks
from repro_torch.kernels.rglru_scan.ops import RgLruScan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.rwkv6_scan.ops import Rwkv6Scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref


def _rwkv_inputs(b, h, t, hd, seed, dtype=torch.float64):
    """r, k, v, w as (B, H, T, hd) views of (B, T, H, hd) tensors (w the
    model's decays exp(-exp(x))), u (H, hd) and dout (B, H, T, hd)."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(0.5 * rng.standard_normal((b, t, h, hd))).to(dtype)
               .transpose(1, 2) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(rng.uniform(-6.0, -0.5, (b, t, h, hd))))).to(
        torch.float64 if dtype == torch.float64 else torch.float32).transpose(1, 2)
    u = torch.from_numpy(0.1 * rng.standard_normal((h, hd))).to(w.dtype)
    dout = torch.from_numpy(rng.standard_normal((b, t, h, hd))).to(w.dtype).transpose(1, 2)
    return (r, k, v, w, u), dout


def _rglru_inputs(b, t, r, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 0.9999, (b, t, r))).to(dtype)
    g = torch.from_numpy(np.sqrt(1 - a.double().numpy() ** 2) * rng.standard_normal((b, t, r)))
    dout = torch.from_numpy(rng.standard_normal((b, t, r)))
    return a, g.to(dtype), dout.to(dtype)


SHAPES = [(t, hd) for t in (1, 7, 40) for hd in (16, 32, 64)]


@pytest.mark.parametrize("t,hd", SHAPES)
def test_rwkv6_bwd_ref_equals_autograd_f64(t, hd):
    xs, dout = _rwkv_inputs(2, 3, t, hd, seed=t * hd)
    xs = [x.clone().requires_grad_() for x in xs]
    # at T 1 the last step's w reaches no output: its gradient is 0
    want = torch.autograd.grad(rwkv6_scan_ref(*xs), xs, dout, materialize_grads=True)
    got = rwkv6_scan_bwd_ref(*xs, dout)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert float((g - w).detach().abs().max()) <= 1e-10


@pytest.mark.parametrize("t", [1, 7, 40])
def test_rglru_bwd_ref_equals_autograd_f64(t):
    a, g, dout = _rglru_inputs(3, t, 24, seed=t)
    a, g = a.requires_grad_(), g.requires_grad_()
    h = rglru_scan_ref(a, g)
    want = torch.autograd.grad(h, (a, g), dout)
    got = rglru_scan_bwd_ref(a, h.detach(), dout)
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,hd", SHAPES)
def test_rwkv6_bwd_ref_f32_within_bound(t, hd, dtype):
    """f32 gradients (bf16 or f32 r, k, v, as the model holds them) within
    the bound of the f64 ones on the same inputs."""
    xs, dout = _rwkv_inputs(2, 3, t, hd, seed=7 * t + hd, dtype=dtype)
    got = rwkv6_scan_bwd_ref(*xs, dout)
    exact = rwkv6_scan_bwd_ref(*(x.double() for x in xs), dout.double())
    for g, e, bound in zip(got, exact, checks.rwkv6_scan_grad_bound(*xs, dout)):
        assert g.dtype == torch.float32
        assert bool(((g.double() - e).abs() <= bound).all())


@pytest.mark.parametrize("t", [1, 7, 40])
def test_rglru_bwd_ref_f32_within_bound(t):
    a, g, dout = _rglru_inputs(3, t, 24, seed=5 * t, dtype=torch.float32)
    got = rglru_scan_bwd_ref(a, rglru_scan_ref(a, g), dout)
    exact = rglru_scan_bwd_ref(a.double(), rglru_scan_ref(a.double(), g.double()),
                               dout.double())
    for x, e, bound in zip(got, exact, checks.rglru_scan_grad_bound(a, g, dout)):
        assert bool(((x.double() - e).abs() <= bound).all())


def test_grad_bounds_are_not_vacuous_at_the_path_shapes():
    """At the training path's T 128 and hd 64 (batch 16, one head) each
    bound is below 1e-3 of its gradient's magnitude (the plain backward on
    absolute values); recurrentgemma's scan at T 128 likewise."""
    xs, dout = _rwkv_inputs(16, 1, 128, 64, seed=3, dtype=torch.bfloat16)
    mags = rwkv6_scan_bwd_ref(*(x.abs().double() for x in xs), dout.abs().double())
    for bound, mag in zip(checks.rwkv6_scan_grad_bound(*xs, dout), mags):
        live = mag > 0
        assert float((bound[live] / mag[live]).max()) < 1e-3
    a, g, dl = _rglru_inputs(2, 128, 64, seed=4, dtype=torch.float32)
    mags = rglru_scan_bwd_ref(a.double(), rglru_scan_ref(a.double(), g.abs().double()),
                              dl.abs().double())
    for bound, mag in zip(checks.rglru_scan_grad_bound(a, g, dl), mags):
        live = mag > 0
        assert float((bound[live] / mag[live]).max()) < 1e-3


def _jax(x):
    return jnp.asarray(x.float().contiguous().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,hd", [(1, 16), (7, 32), (40, 64)])
def test_rwkv6_bwd_ref_matches_jax_vjp(t, hd, dtype):
    xs, dout = _rwkv_inputs(2, 3, t, hd, seed=11 * t + hd, dtype=dtype)
    _, vjp = jax.vjp(jax_rwkv6, *(_jax(x) for x in xs))
    want = vjp(_jax(dout))
    got = rwkv6_scan_bwd_ref(*xs, dout)
    for g, w, bound in zip(got, want, checks.rwkv6_scan_grad_bound(*xs, dout)):
        checks.check_model_kernel(g, torch.from_numpy(np.array(w)), bound)


@pytest.mark.parametrize("t", [1, 7, 40])
def test_rglru_bwd_ref_matches_jax_vjp(t):
    a, g, dout = _rglru_inputs(3, t, 24, seed=13 * t, dtype=torch.float32)
    _, vjp = jax.vjp(jax_rglru, _jax(a), _jax(g))
    want = vjp(_jax(dout))
    got = rglru_scan_bwd_ref(a, rglru_scan_ref(a, g), dout)
    for x, w, bound in zip(got, want, checks.rglru_scan_grad_bound(a, g, dout)):
        checks.check_model_kernel(x, torch.from_numpy(np.array(w)), bound)


@pytest.mark.parametrize("t", [1, 5])
def test_rwkv6_function_gradcheck(t):
    xs, _ = _rwkv_inputs(1, 2, t, 16, seed=t)
    xs = [x.clone().requires_grad_() for x in xs]
    assert torch.autograd.gradcheck(Rwkv6Scan.apply, xs)


@pytest.mark.parametrize("t", [1, 6])
def test_rglru_function_gradcheck(t):
    a, g, _ = _rglru_inputs(2, t, 5, seed=t)
    assert torch.autograd.gradcheck(RgLruScan.apply, (a.requires_grad_(), g.requires_grad_()))


def test_functions_take_the_plain_backward_on_cpu_tensors():
    """On CPU tensors each op's backward is its plain backward, bit for bit,
    with the gradients in the inputs' types (bf16 r, k, v)."""
    xs, dout = _rwkv_inputs(2, 3, 9, 16, seed=1, dtype=torch.bfloat16)
    xa = [x.clone().requires_grad_() for x in xs]
    got = torch.autograd.grad(Rwkv6Scan.apply(*xa), xa, dout)
    for g, want, x in zip(got, rwkv6_scan_bwd_ref(*xs, dout), xs):
        assert g.dtype == x.dtype and torch.equal(g, want.to(x.dtype))
    a, g, dl = _rglru_inputs(2, 9, 8, seed=2, dtype=torch.float32)
    aa, ga = a.clone().requires_grad_(), g.clone().requires_grad_()
    got = torch.autograd.grad(RgLruScan.apply(aa, ga), (aa, ga), dl)
    for x, want in zip(got, rglru_scan_bwd_ref(a, rglru_scan_ref(a, g), dl)):
        assert torch.equal(x, want)
