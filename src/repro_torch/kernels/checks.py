"""The rules a similarity kernel is held to against another implementation.

Two f32 implementations of ``E1 @ E2^T`` that sum in different orders
disagree in the last bits of a score, so their outputs are compared against
the exact (f64) scores of the same inputs:

* **Counts (edge rule).**  An element is *certain* when every weight within
  the f32 error bound of its exact weight falls in one bin; both count tiles
  must hold every certain element in its bin, and may place the others only
  in a bin their error band touches.  The mismatch count is the number of
  elements the two tiles place differently, never more than the uncertain
  elements.
* **Top-k (near-tie rule).**  Sorted values agree within the score bound;
  where two lists name different columns at one position, the two columns'
  exact scores lie within twice the bound of each other.
* **Walk sums.**  Within ``1e-6`` relative of the f64 sum over the exact
  scores.

The score bound is the classical one for a length-d dot product in f32,
``gamma_d * sum_i |a_i b_i|`` with ``gamma_d = d u / (1 - d u)``, ``u =
2**-24`` (bf16 inputs are rounded first, their products are exact in f32);
int8 scores are exact integers scaled twice in f32 (``2u`` relative).
Everything runs in torch on the tensors' device; tests and ``chip_smoke.py``
use it at small and at main-path shapes.

The model-stack kernels (flash attention and the two scans) are held by
:func:`check_model_kernel` to a per-element bound on the error of any f32
evaluation of their function, from the same classical lemma (a term that
passes through n roundings is off by at most ``gamma_n`` of its size):

* **Scans** (:func:`rwkv6_scan_bound`, :func:`rglru_scan_bound`).  The
  output at step t is a sum of products, each through at most ``n_t``
  roundings, so its error is at most ``gamma(n_t)`` times the same
  recurrence run on absolute values: ``n_t = 2t + 2`` for the RG-LRU
  (a multiply and an add per step) and ``2t + hd + 6`` for RWKV6 (the
  state's steps, the bonus term and the length-hd read-out).
* **The scans' gradients** (:func:`rglru_scan_grad_bound`,
  :func:`rwkv6_scan_grad_bound`).  Each gradient is again a sum of
  products; the magnitudes come from the plain backward run on absolute
  values, times ``gamma`` of the longest chain of roundings a term passes
  through in the kernel's order or the plain version's (their docstrings
  count them).
* **Attention** (:func:`flash_attention_bound`).  Each score is a length-d
  dot product (``gamma(d+1)`` of ``scale * |q| . |k|``); each weight
  ``exp(s - max)`` carries its score's error (the max is a factor common to
  the row and cancels), ``u |s - max|`` from the subtraction and a few ulps
  of ``exp`` and of the rescale per tile of the online softmax; the two sums
  over the keys add ``gamma(Skv + 2 tiles + 2)``.  Propagated through
  ``sum p v / sum p`` in f64.
* **Attention's gradients** (:func:`flash_attention_grad_bound`).  The
  same lemma through the backward's recomputation: P from the forward's
  lse, ``dP = dO . v``, ``D = rowsum(dO * O)``, ``dS = P (dP - D)`` and the
  three sums over keys or query rows (its docstring has the terms).

The kernel and the plain version each lie within the bound of the exact
value, so they may differ by twice it; an output stored in bf16 is rounded
once on each side, half a bf16 ulp each.
"""
from __future__ import annotations


import numpy as np
import torch

U = 2.0**-24


def exact_scores(e1, e2, precision="fp32", rs1=None, rs2=None):
    """(S64, bound): f64 scores of the inputs as the kernel sees them, and
    the per-element absolute bound on an f32 implementation's error."""
    if precision == "int8":
        acc = torch.matmul(e1.double(), e2.double().T)
        s = acc * rs1.double()[:, None] * rs2.double()[None, :]
        return s, 2.5 * U * s.abs() + 1e-30
    if precision == "bf16":
        e1 = e1.to(torch.bfloat16)
        e2 = e2.to(torch.bfloat16)
    a, b = e1.double(), e2.double()
    d = a.shape[1]
    gamma = d * U / (1 - d * U)
    return a @ b.T, gamma * (a.abs() @ b.abs().T) + 1e-30


def _f32(x: float) -> float:
    return float(np.float32(x))


def weight_band(s64, bound, exponent, floor, scale=None):
    """Exact f64 weights and the half-width of their f32 error band."""
    fl, ex = _f32(floor), _f32(exponent)
    base = torch.clamp(s64, 0.0, 1.0).clamp_min(fl)
    w = base if ex == 1.0 else base**ex
    # derivative of the transform times the score bound, plus a few f32
    # roundings (pow, scale, bin multiply)
    slope = torch.ones_like(base) if ex == 1.0 else ex * base ** (ex - 1.0)
    dw = slope * bound + 8 * U * w
    if scale is not None:
        sc = scale.double()[:, None]
        w, dw = w * sc, dw * sc
    return w, dw


def _bins(w, n_bins):
    return torch.clamp(torch.floor(w * n_bins), 0, n_bins - 1).long()


def check_counts(block_counts_list, s64, bound, *, n_bins, exponent, floor,
                 bm, scale=None, valid_rows=None, valid_cols=None):
    """Holds each (T, n_bins) count tile in ``block_counts_list`` to the edge
    rule over the elements [:valid_rows, :valid_cols]; returns
    ``{"uncertain": n, "mismatch": m}`` (mismatch between the first two
    tiles, if two are given).  Raises AssertionError on a violation."""
    m, n = s64.shape
    vr = m if valid_rows is None else valid_rows
    vc = n if valid_cols is None else valid_cols
    w, dw = weight_band(s64[:vr, :vc], bound[:vr, :vc], exponent, floor,
                        None if scale is None else scale[:vr])
    lo, hi = _bins(w - dw, n_bins), _bins(w + dw, n_bins)
    tile = (torch.arange(vr, device=s64.device) // bm)[:, None].expand(vr, vc)
    n_tiles = -(-m // bm)
    sure = lo == hi
    certain = torch.bincount((tile[sure] * n_bins + lo[sure]),
                             minlength=n_tiles * n_bins).reshape(n_tiles, n_bins)
    unc = torch.bincount(tile[~sure], minlength=n_tiles)
    # how many uncertain elements of a tile may land in each bin
    reach = torch.zeros(n_tiles * n_bins, dtype=torch.long, device=s64.device)
    if (~sure).any():
        t_u, lo_u, hi_u = tile[~sure], lo[~sure], hi[~sure]
        for off in range(int((hi_u - lo_u).max()) + 1):
            b = lo_u + off
            ok = b <= hi_u
            reach += torch.bincount(t_u[ok] * n_bins + b[ok],
                                    minlength=n_tiles * n_bins)
    reach = reach.reshape(n_tiles, n_bins)
    for bc in block_counts_list:
        bc = bc.to(s64.device).long()
        res = bc - certain
        assert (res >= 0).all(), "a certain element is missing from its bin"
        assert torch.equal(res.sum(dim=1), unc), "count mass differs"
        assert (res <= reach).all(), "an element landed outside its band"
    mismatch = 0
    if len(block_counts_list) >= 2:
        a, b = (x.to(s64.device).long() for x in block_counts_list[:2])
        mismatch = int((a - b).clamp_min(0).sum())
    return {"uncertain": int((~sure).sum()), "mismatch": mismatch}


def check_topk(vals_a, idx_a, vals_b, idx_b, s64, bound):
    """Near-tie rule between two (M, k) top-k results; returns
    ``{"mismatch": positions whose columns differ}``.  Column indices past
    ``s64``'s width name zero padding rows, whose score is exactly 0."""
    dev = s64.device
    vals_a, vals_b = vals_a.to(dev).double(), vals_b.to(dev).double()
    idx_a, idx_b = idx_a.to(dev).long(), idx_b.to(dev).long()
    row_bound = bound.max(dim=1, keepdim=True).values
    assert ((vals_a - vals_b).abs() <= 2 * row_bound).all(), "top-k values differ"
    sc = torch.clamp(s64, 0.0, 1.0)
    extra = int(max(idx_a.max(), idx_b.max())) + 1 - sc.shape[1]
    if extra > 0:
        sc = torch.nn.functional.pad(sc, (0, extra))
    diff = idx_a != idx_b
    if diff.any():
        gap = (torch.gather(sc, 1, idx_a) - torch.gather(sc, 1, idx_b)).abs()[diff]
        assert (gap <= 4 * row_bound.expand_as(diff)[diff]).all(), \
            "top-k columns differ beyond a near-tie"
    return {"mismatch": int(diff.sum())}


def check_sums(row_sums, s64, *, exponent, floor, v=None, rtol=1e-6):
    """Walk sums against the f64 sum over the exact scores; returns the
    largest relative error."""
    fl, ex = _f32(floor), _f32(exponent)
    base = torch.clamp(s64, 0.0, 1.0).clamp_min(fl)
    wr = base if ex == 1.0 else base**ex
    if v is not None:
        wr = wr * v.double()[None, :]
    ref = wr.sum(dim=1)
    got = row_sums.to(s64.device).double()
    rel = ((got - ref).abs() / ref.abs().clamp_min(1e-300)).max()
    assert rel <= rtol, f"walk sums off by {float(rel):.3g} relative"
    return float(rel)


BF16_ULP = 2.0**-7   # a bf16 ulp is at most this much of the value


def gamma(n):
    """``n u / (1 - n u)``: the relative error bound after n f32 roundings."""
    return n * U / (1 - n * U)


def rglru_scan_bound(a, g):
    """(B, T, R) bound on |an f32 evaluation of the RG-LRU scan - exact|."""
    from .rglru_scan.ref import rglru_scan_ref

    t = a.shape[1]
    gam = gamma(2.0 * torch.arange(t, device=a.device, dtype=torch.float64) + 2)
    mag = rglru_scan_ref(a.abs(), g.abs()).double()
    # the magnitudes are themselves an f32 evaluation on nonnegative data:
    # the exact ones are at most mag / (1 - gamma)
    return (gam / (1 - gam))[None, :, None] * mag


def rwkv6_scan_bound(r, k, v, w, u):
    """(B, H, T, hd) bound on |an f32 evaluation of the RWKV6 scan - exact|."""
    from .rwkv6_scan.ref import rwkv6_scan_ref

    t, hd = r.shape[2], r.shape[3]
    gam = gamma(2.0 * torch.arange(t, device=r.device, dtype=torch.float64) + hd + 6)
    mag = rwkv6_scan_ref(r.abs(), k.abs(), v.abs(), w.abs(), u.abs()).double()
    return (gam / (1 - gam))[:, None] * mag


def rglru_scan_grad_bound(a, g, dout):
    """Bounds (da, dg), (B, T, R) each, on |an f32 evaluation of the RG-LRU
    scan's gradients - exact|, for the cotangent ``dout`` of its output.
    The terms and their roundings (t from 0, T steps):

    * the saved output h_{t-1}: 2t roundings in the plain version's order (a
      multiply and an add a step), t in the kernel's (one fma a step);
    * Lambda_t = dout_t + a_{t+1} Lambda_{t+1}: a term of dout_s passes
      2(s - t) roundings in the plain order, s - t in the kernel's (fma);
      dg_t = Lambda_t, so at most 2(T - 1 - t);
    * da_t = Lambda_t h_{t-1}: the two chains and the product, at most
      2(T - 1 - t) + 2t + 1 < 2T.

    So every term passes at most n = 2T + 2 roundings and the error is at
    most ``gamma(n)`` times the sum of the terms' magnitudes: the plain
    backward run in f64 on |a|, |g| and |dout| (whose forward gives the
    magnitudes of h)."""
    from .rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref

    a64, g64, d64 = (x.detach().abs().double() for x in (a, g, dout))
    gam = gamma(2.0 * a.shape[1] + 2)
    return tuple(gam * m for m in rglru_scan_bwd_ref(a64, rglru_scan_ref(a64, g64), d64))


def rwkv6_scan_grad_bound(r, k, v, w, u, dout):
    """Bounds (dr, dk, dv, dw (B, H, T, hd), du (H, hd)) on |an f32
    evaluation of the RWKV6 scan's gradients - exact|, for the cotangent
    ``dout`` of its output (``rwkv6_scan_bwd_ref`` has the recurrences).
    The chains of roundings, T steps, head width hd, B batches:

    * S_{t-1} (recomputed): a term k_s v_s passes a product and one
      rounding a step in the kernel (an fma), two in the plain order:
      at most 2T;
    * G_t: a term r_s^T dout_s likewise: at most 2T + 1;
    * dr, dk and dv sum a product of one of those with an operand over hd
      columns or rows, then add the bonus term u k (dout . v), u r (dout .
      v) or dout sum r u k, itself a length-hd dot product.  The kernel
      splits a head's columns over a cluster of hd / 16 CTAs and sums a row
      over a thread's 8 columns by fma, then over the row's two threads,
      then over the cluster's ranks in order (dr, dk, dw: at most 8 + 1 + 7
      roundings at hd 128), or a column over a warp's 16 rows by a
      butterfly and over the CTA's warps in order (dv, at most 4 + 8 at hd
      128); any order of the plain version's sums over hd terms passes at
      most hd: at most 2T + hd + 24 in all;
    * dw_t = sum_j G_t S_{t-1}: both chains, the product and the sum over
      hd: at most 4T + hd + 24;
    * du = sum over b and t of r k (dout . v): the dot product (hd + 6 in
      the kernel's butterfly), the products, then T steps and B batches
      added in order: at most T + B + hd + 10.

    Each error is at most ``gamma`` of its chain times the sum of its
    terms' magnitudes: the plain backward run in f64 on the absolute
    values."""
    from .rwkv6_scan.ref import rwkv6_scan_bwd_ref

    b, _, t, hd = r.shape
    mags = rwkv6_scan_bwd_ref(*(x.detach().abs().double() for x in (r, k, v, w, u, dout)))
    chains = (2 * t + hd + 24,) * 3 + (4 * t + hd + 24, t + b + hd + 10)
    return tuple(gamma(float(n)) * m for n, m in zip(chains, mags))


FA_TILE = 64   # the CUDA kernel's KV tile: each tile rescales the running sums


def flash_attention_bound(q, k, v, causal=True, window=0):
    """(B, Hq, Sq, dv) bound on |an f32 evaluation of softmax attention -
    exact|, for the online softmax over KV tiles of ``FA_TILE`` keys as
    well as for one softmax over the whole row (q and k ``d`` wide, v
    ``dv``).  A row whose keys are all masked averages every value (all its
    scores are the same -1e30)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    tiles = -(-skv // FA_TILE)
    scale = d**-0.5
    g_dot = gamma(d + 1)
    g_sum = gamma(skv + 2 * tiles + 2)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qp >= kp
    if window > 0:
        mask = mask & (qp - kp < window)
    empty = ~mask.any(-1, keepdim=True)
    use = mask | empty
    out = torch.empty((b, hq, sq, v.shape[-1]), dtype=torch.float64, device=q.device)
    for h in range(hq):   # one q head at a time: (B, Sq, Skv) temporaries
        qh = q[:, h].double()
        kh, vh = k[:, h // (hq // hkv)].double(), v[:, h // (hq // hkv)].double()
        s = torch.where(mask, scale * qh @ kh.transpose(1, 2), 0.0)
        ds = torch.where(mask, g_dot * scale * (qh.abs() @ kh.abs().transpose(1, 2)), 0.0)
        s = torch.where(use, s, -torch.inf)
        x = s - s.amax(-1, keepdim=True)
        p = torch.exp(x)
        x = torch.where(use, x, 0.0)
        dmax = torch.where(use, ds, 0.0).amax(-1, keepdim=True)
        # relative error of a weight: its score's (the row max is a common
        # factor and cancels), the subtraction from the computed max, and
        # exp plus one rescale per tile, a few ulps each
        rho = torch.expm1(ds + U * (x.abs() + ds + dmax) + 5 * U * (tiles + 1))
        e = torch.where(use, p * (rho + g_sum * (1 + rho)), 0.0)
        den = p.sum(-1, keepdim=True)
        o = (p @ vh) / den
        err = (e @ vh.abs() + o.abs() * e.sum(-1, keepdim=True)) / (den - e.sum(-1, keepdim=True))
        out[:, h] = err * (1 + U) + U * o.abs()
    return out


def flash_attention_grad_bound(q, k, v, do, causal=True, window=0):
    """Bounds (dq (B, Hq, Sq, d), dk, dv (B, Hkv, Skv, d)) on |an f32
    evaluation of the gradients of softmax attention - exact|, for a
    backward that recomputes ``P = exp(s - lse)`` from the forward's f32
    row log-sum-exp and takes ``D = rowsum(dO * O)`` from the forward's
    output.  Derived as :func:`flash_attention_bound` is:

    * the forward's lse is off by the largest score error of its row
      (``dmax``), the relative error of its sum (``gamma(Skv + 2 tiles +
      2)`` and a few ulps a tile), and the ulps of ``log`` and of ``m +
      log l``; a weight then carries its score's error, the lse's and
      ``u |s - lse|``, so ``|P' - P| <= P rho``;
    * ``dP = dO . v`` is a length-d dot product (``gamma(d+1)`` of
      ``|dO| . |v|``); ``D`` sums ``dO * O'`` over d, where ``O'`` is the
      forward's output, within :func:`flash_attention_bound` (and half a
      bf16 ulp when stored in bf16) of the exact one;
    * ``dS = P (dP - D)`` is then within ``(P + eP)(A + E)(1 + u)^2 - P A``
      with ``A = |dP - D|`` and ``E`` the errors of dP and D; a masked
      score has ``dS = 0`` exactly;
    * each gradient is a sum over the keys (dq) or over the q rows of
      every head of the group (dk, dv): the terms' errors plus
      ``gamma(n + 2)`` of the sum of their magnitudes.

    A row whose keys are all masked has ``P = 1 / Skv`` (the forward
    averages every value) and adds to dv only."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    tiles = -(-skv // FA_TILE)
    scale = d**-0.5
    g_dot = gamma(d + 1)
    g_sum = gamma(skv + 2 * tiles + 2)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qp >= kp
    if window > 0:
        mask = mask & (qp - kp < window)
    empty = ~mask.any(-1, keepdim=True)
    o_err = flash_attention_bound(q, k, v, causal=causal, window=window)
    edq = torch.empty((b, hq, sq, d), dtype=torch.float64, device=q.device)
    edk = torch.zeros((b, hkv, skv, d), dtype=torch.float64, device=q.device)
    edv = torch.zeros_like(edk)
    g_dk = gamma(g * sq + 2)
    for h in range(hq):
        qh, doh = q[:, h].double(), do[:, h].double()
        kh, vh = k[:, h // g].double(), v[:, h // g].double()
        s = torch.where(mask, scale * qh @ kh.transpose(1, 2), 0.0)
        ds = torch.where(mask, g_dot * scale * (qh.abs() @ kh.abs().transpose(1, 2)), 0.0)
        dmax = ds.amax(-1, keepdim=True)
        lse = torch.logsumexp(torch.where(mask, s, -torch.inf), -1, keepdim=True)
        lse = torch.where(empty, 0.0, lse)
        eps = g_sum + 5 * U * (tiles + 2)
        d_lse = dmax + eps / (1 - eps) + U * (lse.abs() + np.log(skv) + 2)
        x = torch.where(mask, s - lse, 0.0)
        p = torch.where(mask, torch.exp(x), 0.0)
        rho = torch.where(mask, torch.expm1(ds + d_lse + U * (x.abs() + ds + d_lse) + 3 * U), 0.0)
        p = torch.where(empty, 1.0 / skv, p)
        rho = torch.where(empty, 2 * U, rho)
        e_p = p * rho
        dp = doh @ vh.transpose(1, 2)
        e_dp = g_dot * (doh.abs() @ vh.abs().transpose(1, 2))
        o_h, oe_h = p @ vh, o_err[:, h]
        if q.dtype == torch.bfloat16:
            oe_h = oe_h + 0.5 * BF16_ULP * o_h.abs()
        dd = (doh * o_h).sum(-1, keepdim=True)
        e_d = (doh.abs() * oe_h).sum(-1, keepdim=True) + g_dot * (
            doh.abs() * (o_h.abs() + oe_h)).sum(-1, keepdim=True)
        a = (dp - dd).abs()
        e = e_dp + e_d
        live = mask & ~empty
        dsm = torch.where(live, p * a, 0.0)
        e_ds = torch.where(live, (p + e_p) * (a + e) * (1 + U) ** 2 - p * a, 0.0)
        mag = dsm + e_ds
        edq[:, h] = scale * (e_ds @ kh.abs() + (gamma(skv + 2) + 2 * U) * (mag @ kh.abs()))
        edk[:, h // g] += scale * (e_ds.transpose(1, 2) @ qh.abs()
                                   + (g_dk + 2 * U) * (mag.transpose(1, 2) @ qh.abs()))
        edv[:, h // g] += (e_p.transpose(1, 2) @ doh.abs()
                           + g_dk * ((p + e_p).transpose(1, 2) @ doh.abs()))
    return edq, edk, edv


def check_model_kernel(got, want, bound):
    """A model-stack kernel's output against its plain version's.  ``bound``
    is the per-element bound on either side's error (``*_bound`` above);
    the two may differ by twice it, plus half a bf16 ulp on each side for a
    bf16 output.  Raises where an element differs by more; returns the
    largest difference, the largest |want|, the largest tolerance and the
    largest ratio of difference to tolerance (the margin is its inverse)."""
    g, w = got.double(), want.to(got.device).double()
    err = (g - w).abs()
    tol = 2 * bound.to(got.device).double()
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * torch.maximum(g.abs(), w.abs())
    ratio = float((err / tol.clamp_min(1e-300)).max())
    bad = int((err > tol).sum())
    assert bad == 0, (f"{bad} elements differ beyond the bound (max {float(err.max()):.3g}, "
                      f"{ratio:.3g} times the tolerance)")
    return {"max_abs_err": float(err.max()), "max_abs_want": float(w.abs().max()),
            "max_tolerance": float(tol.max()), "err_over_tol": ratio}
