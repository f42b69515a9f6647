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
