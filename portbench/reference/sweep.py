"""Plain stratification of a two-table join: the weight of every pair, its
histogram, each left row's weight sum and the heaviest pairs, from blocked
f32 products on the device; then the numbers that judge a stratification
the system produced against them.

A pair's weight is its embeddings' dot product clipped to [0, 1] and raised
to the floor (the paper's sampling weight at exponent 1).  The histogram
puts weight w in bin floor(w * n_bins), the top edge in the last bin.  The
blocking regime is the m = round(alpha * budget) heaviest pairs, cut into
K equal strata of descending weight, K = clip(m // 1000, 5, 64) (the
paper's rule: about 1,000 of the budget a stratum, at least 5).

Imports nothing of the program.  ``tf32=True`` rounds the inputs as a
TF32 tensor core does (10 mantissa bits, to nearest even), which is the
control: the same computation one precision below the configuration's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ALPHA = 0.2
LANES = 64
MIN_STRATA, MAX_STRATA, BUDGET_PER_STRATUM = 5, 64, 1000


def blocking_size(budget: int, n_pairs: int) -> tuple:
    """(m, K): the blocking regime's pairs and its number of strata."""
    m = min(int(round(ALPHA * budget)), n_pairs)
    k = int(np.clip(m // BUDGET_PER_STRATUM, MIN_STRATA, MAX_STRATA))
    return m, max(1, min(k, m))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _weights(scores: torch.Tensor, floor: float, exponent: float) -> torch.Tensor:
    w = scores.clamp_(0.0, 1.0).clamp_min_(floor)
    return w if exponent == 1.0 else w.pow_(exponent)


@dataclasses.dataclass
class Sweep:
    counts: np.ndarray        # (n_bins,) int64
    row_sums: np.ndarray      # (n1,) float64: sum of a left row's weights
    total: float
    top: np.ndarray           # flat indices of the heaviest pairs, heaviest first
    top_w: np.ndarray         # their f32 weights


def sweep(e1: np.ndarray, e2: np.ndarray, n_bins: int, keep: int, floor: float = 1e-3,
          exponent: float = 1.0, block_rows: int = 1024, tf32: bool = False,
          device="cuda") -> Sweep:
    """One blocked pass over E1 @ E2^T in f32; ``keep`` heaviest pairs kept."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    t1 = torch.from_numpy(np.ascontiguousarray(e1, np.float32)).to(dev)
    t2 = torch.from_numpy(np.ascontiguousarray(e2, np.float32)).to(dev)
    if tf32:
        t1, t2 = round_tf32(t1), round_tf32(t2)
    n1, n2 = t1.shape[0], t2.shape[0]
    counts = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    # each column counts into one of LANES copies of the histogram, so the
    # floor's bin, which holds about half the pairs, is not one hot counter
    lanes = (torch.arange(n2, device=dev, dtype=torch.int32) % LANES) * n_bins
    row_sums = torch.empty(n1, dtype=torch.float64, device=dev)
    top_w = torch.empty(0, device=dev)
    top_i = torch.empty(0, dtype=torch.int64, device=dev)
    for s in range(0, n1, block_rows):
        w = _weights(t1[s:s + block_rows] @ t2.T, floor, exponent)
        rows = w.shape[0]
        bins = (w * n_bins).to(torch.int32).clamp_(max=n_bins - 1).add_(lanes)
        counts += torch.bincount(bins.view(-1), minlength=LANES * n_bins).view(
            LANES, n_bins).sum(0)
        del bins
        row_sums[s:s + rows] = w.sum(dim=1, dtype=torch.float64)
        if len(top_w) < keep:
            v, i = torch.topk(w.view(-1), min(keep, w.numel()))
        else:
            i = torch.nonzero(w.view(-1) >= top_w[-1]).view(-1)
            v = w.view(-1)[i]
        flat = (i // n2 + s) * n2 + i % n2
        v, order = torch.sort(torch.cat([top_w, v]), descending=True, stable=True)
        top_w, top_i = v[:keep], torch.cat([top_i, flat])[order][:keep]
        del w
    return Sweep(counts=counts.cpu().numpy(), row_sums=row_sums.cpu().numpy(),
                 total=float(row_sums.sum()), top=top_i.cpu().numpy(),
                 top_w=top_w.float().cpu().numpy())


def exact_weights(e1: np.ndarray, e2: np.ndarray, flat: np.ndarray, floor: float = 1e-3,
                  exponent: float = 1.0) -> np.ndarray:
    """f64 weights of the pairs ``flat`` (row-major flat indices)."""
    n2 = e2.shape[0]
    i, j = np.asarray(flat) // n2, np.asarray(flat) % n2
    s = np.einsum("nd,nd->n", e1[i].astype(np.float64), e2[j].astype(np.float64))
    w = np.maximum(np.clip(s, 0.0, 1.0), floor)
    return w if exponent == 1.0 else w**exponent


@dataclasses.dataclass
class Strata:
    """A stratification as the system hands it out: its histogram, the
    blocking regime in descending order cut at ``bounds``, the row sums."""
    counts: np.ndarray
    order: np.ndarray
    bounds: np.ndarray
    row_sums: np.ndarray
    total: float


def as_strata(sw: Sweep, m: int, k: int) -> Strata:
    """The stratification a sweep gives, as the system would cut it."""
    order = sw.top[:m]
    bounds = np.round(np.linspace(0, len(order), k + 1)).astype(np.int64)
    return Strata(sw.counts, order, bounds, sw.row_sums, sw.total)


def judge(st: Strata, ref: Sweep, e1: np.ndarray, e2: np.ndarray, floor: float = 1e-3,
          exponent: float = 1.0) -> dict:
    """The numbers that judge ``st`` against the reference sweep:

    * ``hist_l1``: the L1 distance of the histograms over the pairs;
    * ``strata_gap``: the largest amount by which a pair in a later stratum
      (or outside the blocking regime) outweighs one in an earlier stratum,
      in exact f64 weights (0 when every boundary is in order);
    * ``rowsum_rel``: the largest relative error of a row sum or the total.
    """
    hist = float(np.abs(st.counts - ref.counts).sum() / max(ref.counts.sum(), 1))
    w = exact_weights(e1, e2, st.order, floor, exponent)
    outside = np.setdiff1d(ref.top, st.order)
    w_out = exact_weights(e1, e2, outside, floor, exponent).max(initial=0.0)
    gap = 0.0
    for j in range(1, len(st.bounds)):
        later = w[st.bounds[j]:].max(initial=0.0)
        if j == len(st.bounds) - 1:
            later = max(later, w_out)
        if st.bounds[j] > 0:
            gap = max(gap, later - w[:st.bounds[j]].min())
    rs = np.abs(st.row_sums - ref.row_sums) / np.maximum(ref.row_sums, 1e-300)
    tot = abs(st.total - ref.total) / max(ref.total, 1e-300)
    return {"hist_l1": hist, "strata_gap": float(gap), "rowsum_rel": float(max(rs.max(), tot))}
