"""Stratification of the cross product (paper Alg. 4 lines 1-5).

Two paths:

* **dense/exact** — materialised flat weights, one argsort; strata are
  contiguous index ranges of the descending order.  Used when the cross
  product fits in memory (paper's own prototype does the same with SortDesc).
* **streaming/single-sweep** — **one** blocked pass of ``E1 @ E2^T``
  (CUDA kernel ``sim_sweep`` on the card, its plain PyTorch version on the
  CPU; ``use_kernel=False`` is the blocked host configuration) emits the global weight histogram, per-(row-block,
  bin) count tiles, and the per-row top-k.  The top-m threshold is the
  histogram CDF quantile; collection reads the top-k candidates and rescans
  only the row blocks whose count tiles prove over-threshold mass — so the
  paper's O(N^2 log N^2) sort becomes ~one O(N^2) streaming pass, and the
  cross product is never materialised.  (The two-pass histogram-then-collect
  path is kept behind ``use_sweep=False`` as the bit-identical baseline.)

k-way chains (``stratify_streaming_chain``): the chain weight factorises as
prefix-weight x last-edge pair weight, so the sweep enumerates the chain's
*prefix* space in blocks and hands the accumulated prefix weight to the
kernel as a per-row scale.  Histogram resolution: chain weights are products
of k-1 terms and concentrate near zero on a linear [0, 1] grid, so the
histogram bins the geometric-mean weight W**(1/(k-1)) (a monotone transform —
identical to the raw weight at k=2); the top-m threshold maps back as
thr**(k-1).  Memory stays O(N + bins + block*Nk + m).

Precision: the sweep runs fp32 by default (bit-identical to the two-pass
path).  ``precision="bf16"``/``"int8"`` (see
``configs.joinml_embedder.EMBEDDING_PRECISIONS``) opt into the low-precision
path; the first row block is re-binned at fp32 and the sweep falls back to
fp32 when the CDF deviation exceeds the configured tolerance.  That fallback
is a statistical rule, not a device fallback: with ``use_kernel=True`` on a
CUDA device every kernel launches or raises.

Device: every entry point takes ``device=`` (default ``"cuda"``, which
raises without a card); only the tests pass ``"cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..obs.telemetry import span
from .types import BASConfig


@dataclasses.dataclass
class Stratification:
    """Strata over a flat pair space.

    ``order``: flat indices sorted by weight descending (top region only for
    streaming mode — then ``order`` covers exactly the maximum blocking
    regime and ``rest_mask`` identifies D_0 implicitly).
    ``bounds``: (K+1,) ints; stratum i (1-indexed as in the paper) is
    ``order[bounds[i-1]:bounds[i]]``.  D_0 is everything not in ``order[:bounds[-1]]``.
    ``order_weights``: sampling weights aligned with ``order`` when the
    streaming collector produced them (f64; None on the dense path).
    ``sweep``: the :class:`SweepInfo` that stratified this space, when the
    single-sweep path ran (None otherwise) — samplers consume its count
    tiles and stats.
    """

    order: np.ndarray
    bounds: np.ndarray
    n_total: int
    order_weights: Optional[np.ndarray] = None
    sweep: Optional["SweepInfo"] = None

    @property
    def num_strata(self) -> int:
        return len(self.bounds) - 1

    def stratum_indices(self, i: int) -> np.ndarray:
        """Flat indices of stratum i in {1..K}."""
        assert 1 <= i <= self.num_strata
        return self.order[self.bounds[i - 1] : self.bounds[i]]

    def stratum_weights(self, i: int) -> Optional[np.ndarray]:
        """Collector-produced weights of stratum i, if available."""
        if self.order_weights is None:
            return None
        return self.order_weights[self.bounds[i - 1] : self.bounds[i]]

    def stratum_sizes(self) -> np.ndarray:
        """Sizes of [D_0, D_1, ..., D_K]."""
        top = np.diff(self.bounds)
        d0 = self.n_total - int(self.bounds[-1])
        return np.concatenate([[d0], top]).astype(np.int64)

    def blocking_regime_size(self) -> int:
        return int(self.bounds[-1])

    def d0_mask(self, n: int) -> np.ndarray:
        m = np.ones(n, dtype=bool)
        m[self.order[: self.bounds[-1]]] = False
        return m


def auto_num_strata(alpha: float, budget: int, cfg: BASConfig) -> int:
    """Paper §5.3/§5.5: K s.t. each stratum gets >= ~1000 Oracle budget,
    clamped to [min_strata, max_strata]."""
    k = int(alpha * budget) // cfg.budget_per_stratum
    return int(np.clip(k, cfg.min_strata, cfg.max_strata))


def stratify_dense(
    weights: np.ndarray, alpha: float, budget: int, cfg: BASConfig
) -> Stratification:
    """Exact stratification by sorting flat weights descending."""
    weights = np.asarray(weights).reshape(-1)
    n = weights.shape[0]
    m = min(int(round(alpha * budget)), n)
    k = auto_num_strata(alpha, budget, cfg)
    k = max(1, min(k, m)) if m > 0 else 0
    if m == 0:
        return Stratification(
            order=np.empty((0,), np.int64), bounds=np.zeros((1,), np.int64), n_total=n
        )
    # argpartition for top-m then sort only those (O(n + m log m))
    if m < n:
        top = np.argpartition(weights, n - m)[n - m :]
    else:
        top = np.arange(n)
    top = top[np.argsort(weights[top])[::-1]]
    bounds = np.round(np.linspace(0, m, k + 1)).astype(np.int64)
    return Stratification(order=top.astype(np.int64), bounds=bounds, n_total=n)


# ----------------------------------------------------------------------------
# Single-sweep streaming path (sim_sweep Pallas kernel with numpy fallback).
# ----------------------------------------------------------------------------

# Per-row candidate budget of the sweep's top-k output.  The top-k collection
# path only engages when the blocking regime averages < 16 pairs per left row
# (see collect_top), so 32 gives 2x headroom; rows that saturate it get one
# raised-k retry and an exact rescan after that (_collect_from_topk) — no
# pair is ever dropped at the cap.
TOPK_CANDIDATES = 32


@dataclasses.dataclass
class SweepInfo:
    """Everything one fused pass over the (never materialised) product
    yields: the global histogram, per-(row-block, bin) count tiles at
    ``block_rows`` left/prefix-row granularity, (two-table kernel path
    only) the per-row top-k candidates, and the walk statistics
    (``row_sums`` per edge + chain ``total_weight``) the streaming sampler
    needs for its proposal normalisation — fused into the same pass, so
    walk setup never re-reads the cross product.  ``stats`` accumulates
    collection bookkeeping (blocks rescanned vs proven empty, retry
    counts) that the BAS engines surface in ``QueryResult.detail``.

    ``row_sums``/``total_weight`` are only attached when the sweep ran at
    effective fp32 (kernel compensated accumulation, or the f64 numpy
    fallback) — low-precision sweeps leave them ``None`` so consumers
    recompute exactly rather than inherit bf16/int8 error into the
    Horvitz–Thompson weights."""

    counts: np.ndarray
    edges: np.ndarray
    block_counts: np.ndarray
    block_rows: int
    topk: Optional[tuple]       # (vals, idx, valid) or None
    kernel: bool
    precision: str
    stats: dict = dataclasses.field(default_factory=dict)
    row_sums: Optional[list] = None     # per-edge (n_j,) f64 walk sums
    total_weight: Optional[float] = None

    @property
    def n_bins(self) -> int:
        return len(self.counts)

    def threshold_bin(self, threshold: float) -> int:
        """Bin index of a histogram-edge threshold."""
        return int(np.clip(round(threshold * self.n_bins), 0, self.n_bins))

    def blocks_over(self, threshold: float, margin: Optional[int] = None) -> np.ndarray:
        """Boolean mask over row blocks that may hold weight >= threshold.

        ``margin`` bins of slack absorb binning-precision mismatch between
        the sweep (f32 scores) and host rescans (f64 transform of f32
        matmuls); low-precision sweeps get a wider default margin."""
        if margin is None:
            margin = 2 if self.precision == "fp32" else max(2, self.n_bins // 64)
        lo = max(self.threshold_bin(threshold) - margin, 0)
        return self.block_counts[:, lo:].sum(axis=1) > 0

    def rescan_starts(self, threshold: float, n_rows: int) -> tuple[list, int]:
        """Row offsets of the blocks a >= threshold rescan must touch (and
        the block stride), skipping blocks the count tiles prove empty;
        records the skip accounting in ``stats``."""
        over = self.blocks_over(threshold)
        starts = [
            b * self.block_rows for b in np.nonzero(over)[0]
            if b * self.block_rows < n_rows
        ]
        self.stats["blocks_total"] = int(len(over))
        self.stats["blocks_rescanned"] = int(len(starts))
        return starts, self.block_rows


def _kernel_sweep(e1, e2, n_bins, exponent, floor, scale=None,
                  precision="fp32", k_top=TOPK_CANDIDATES, right=None,
                  rs_exponent=None, block=None, device="cuda"):
    """Fused sweep: the kernel on a CUDA device, its plain version on the
    CPU.  Never returns None: a failed build or launch raises.  ``block``
    (default: the op's own) caps the count tiles' rows."""
    from ..kernels.sim_sweep.ops import sim_sweep

    kwargs = {} if block is None else {"block": block}
    return sim_sweep(e1, e2, n_bins, exponent, floor, k=k_top, scale=scale,
                     precision=precision, right=right,
                     rs_exponent=rs_exponent, device=device, **kwargs)


def _warn_lowp_unavailable(precision):
    import warnings

    warnings.warn(
        f"{precision} sweep requested with use_kernel=False; the blocked "
        "host path computes fp32"
    )


def _precision_tolerance(precision: str, tolerance: Optional[float]) -> Optional[float]:
    """Validate a sweep precision against the embedder's export table and
    resolve the CDF-shift tolerance (explicit value wins)."""
    from ..configs.joinml_embedder import EMBEDDING_PRECISIONS

    if precision not in EMBEDDING_PRECISIONS:
        raise ValueError(
            f"unknown sweep precision {precision!r}; "
            f"expected one of {sorted(EMBEDDING_PRECISIONS)}"
        )
    if tolerance is not None:
        return tolerance
    return EMBEDDING_PRECISIONS[precision].max_cdf_shift or None


def _binned_counts(w: np.ndarray, n_bins: int) -> np.ndarray:
    """Host-side floor-binning matching the kernel's bin assignment."""
    idx = np.clip((np.asarray(w) * n_bins).astype(np.int64), 0, n_bins - 1)
    return np.bincount(idx.reshape(-1), minlength=n_bins).astype(np.int64)


def _lowp_cdf_dev(ref_counts: np.ndarray, lowp_counts: np.ndarray) -> float:
    """Sup-distance between two normalised histogram CDFs."""
    mass = max(float(ref_counts.sum()), 1.0)
    dev = np.abs(np.cumsum(ref_counts) - np.cumsum(lowp_counts)) / mass
    return float(dev.max())


def _over_threshold(e1, e2, threshold, exponent, floor, device,
                    row_weight=None):
    """Pairs of one row block whose weight clears ``threshold``: returns
    ``(r, c, w)`` as numpy, row-major, ``w`` float64.  The weights are the
    f32 pair weights widened to f64 (times the f64 ``row_weight`` of chain
    prefixes), compared on the device so only the hits cross to the host —
    the same numbers and order as thresholding :func:`pair_weights`."""
    import torch

    from .similarity import as_f32_tensor, pair_weights_t

    dev = resolve_device(device)
    w = pair_weights_t(as_f32_tensor(e1, dev), as_f32_tensor(e2, dev),
                       exponent, floor).double()
    if row_weight is not None:
        w = torch.from_numpy(np.asarray(row_weight, np.float64)).to(dev)[:, None] * w
    r, c = torch.nonzero(w >= threshold, as_tuple=True)
    return r.cpu().numpy(), c.cpu().numpy(), w[r, c].cpu().numpy()


def sweep_pass(
    e1: np.ndarray,
    e2: np.ndarray,
    n_bins: int = 4096,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = False,
    precision: str = "fp32",
    tolerance: Optional[float] = None,
    k_top: int = TOPK_CANDIDATES,
    artifact=None,
    kernel_block: Optional[int] = None,
    device="cuda",
) -> SweepInfo:
    """One pass over the two-table product: histogram + count tiles + top-k.

    ``kernel_block`` caps the kernel path's row-block (tile stride) — index
    maintenance passes the artifact's ``block_rows`` so delta tiles nest
    into the stored ones even after the table outgrows its original
    power-of-two bucket.

    ``k_top`` sizes the top-k output; callers that know collection will go
    dense (m_cap >= 16 * n1) pass 1 to skip most of its cost.  The blocked
    host path (``use_kernel=False``) makes the same single pass in
    ``block``-row chunks (np.histogram per chunk gives the count tiles for
    free); it has no top-k output, so collection rescans — but only the
    blocks the tiles flag.  Low-precision sweeps are tolerance-checked: the
    first row block is re-binned at fp32 and the whole sweep falls back to
    fp32 when the CDF deviation exceeds ``tolerance``.

    ``artifact`` (a :class:`repro_torch.core.index.IndexArtifact`) skips
    the pass entirely and hydrates the stored sweep instead — bit-identical
    at fp32 because the artifact is a prior pass's output; the artifact
    must cover exactly these tables and this binning config (checked).
    """
    from .similarity import pair_weights  # local import to avoid cycle

    if artifact is not None:
        artifact.check(sizes=(e1.shape[0], e2.shape[0]), n_bins=n_bins,
                       exponent=exponent, floor=floor)
        return artifact.sweep_info()
    tolerance = _precision_tolerance(precision, tolerance)
    if use_kernel:
        out = _kernel_sweep(e1, e2, n_bins, exponent, floor,
                            precision=precision, k_top=k_top,
                            block=kernel_block, device=device)
        info = SweepInfo(
            counts=out.counts, edges=out.edges,
            block_counts=out.block_counts, block_rows=out.block_rows,
            topk=(out.vals, out.idx, out.valid) if k_top >= 2 else None,
            kernel=True, precision=precision,
        )
        if precision == "fp32":
            # compensated fused walk sums (~1 f32 ulp of the f64
            # reference); lowp sums would leak quantisation error into
            # the HT weights, so those paths recompute instead
            info.row_sums = [out.row_sums]
            info.total_weight = float(out.row_sums.sum())
        if precision != "fp32":
            rows = min(info.block_rows, e1.shape[0])
            ref = _binned_counts(
                pair_weights(e1[:rows], e2, exponent, floor, device=device),
                n_bins,
            )
            dev = _lowp_cdf_dev(ref, info.block_counts[0])
            info.stats["lowp_cdf_dev"] = dev
            if tolerance is not None and dev > tolerance:
                import warnings

                warnings.warn(
                    f"{precision} sweep CDF deviation {dev:.4f} exceeds "
                    f"tolerance {tolerance:.4f}; falling back to fp32"
                )
                info = sweep_pass(
                    e1, e2, n_bins, exponent, floor, block, use_kernel,
                    precision="fp32", k_top=k_top, kernel_block=kernel_block,
                    device=device,
                )
                info.stats["lowp_fallback"] = dev
        return info

    if precision != "fp32":
        _warn_lowp_unavailable(precision)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    n1 = e1.shape[0]
    tiles = []
    sums = []
    for s in range(0, n1, block):
        w = pair_weights(e1[s : s + block], e2, exponent, floor, device=device)
        c, _ = np.histogram(w, bins=edges)
        tiles.append(c.astype(np.int64))
        sums.append(w.sum(axis=1))  # f64: the walk sums come free here
    bc = np.stack(tiles) if tiles else np.zeros((1, n_bins), np.int64)
    row_sums = np.concatenate(sums) if sums else np.zeros(0, np.float64)
    return SweepInfo(
        counts=bc.sum(axis=0), edges=edges, block_counts=bc, block_rows=block,
        topk=None, kernel=False, precision="fp32",
        row_sums=[row_sums], total_weight=float(row_sums.sum()),
    )


def _prefix_chain_weights(embeddings, start, stop, exponent, floor):
    """Chain weights of prefix tuples [start, stop) in the row-major flat
    order of the *prefix* cross product (all tables but the last).  Returns
    (weights, last_prefix_table_indices)."""
    from .similarity import chain_tuple_weights, flat_to_tuples

    prefix_sizes = tuple(e.shape[0] for e in embeddings[:-1])
    flat = np.arange(start, stop, dtype=np.int64)
    tup = flat_to_tuples(flat, prefix_sizes)
    if len(prefix_sizes) == 1:
        return np.ones(len(flat), np.float64), tup[:, -1]
    wp = chain_tuple_weights(embeddings[:-1], tup, exponent, floor)
    return wp, tup[:, -1]


def sweep_pass_chain(
    embeddings: list,
    n_bins: int = 4096,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = False,
    precision: str = "fp32",
    tolerance: Optional[float] = None,
    k_top: int = TOPK_CANDIDATES,
    artifact=None,
    device="cuda",
) -> SweepInfo:
    """k-way chain sweep: the geometric-mean chain weight W(t)**(1/(k-1)) is
    histogrammed over prefix blocks; each prefix block contributes one
    count tile, so chain collection can skip prefix blocks with no
    over-threshold mass.  At k=2 this is exactly :func:`sweep_pass`.
    ``artifact`` hydrates a stored sweep instead of computing (see
    :func:`sweep_pass`)."""
    from ..kernels.sim_sweep.ops import prepare_right
    from .similarity import pair_weights

    k = len(embeddings)
    if k == 2:
        return sweep_pass(
            embeddings[0], embeddings[1], n_bins, exponent, floor, block,
            use_kernel, precision, tolerance, k_top=k_top, artifact=artifact,
            device=device,
        )
    if artifact is not None:
        artifact.check(sizes=tuple(e.shape[0] for e in embeddings),
                       n_bins=n_bins, exponent=exponent, floor=floor)
        return artifact.sweep_info()
    tolerance = _precision_tolerance(precision, tolerance)
    root = 1.0 / (k - 1)
    e_prev, e_last = embeddings[-2], embeddings[-1]
    n_prefix = 1
    for e in embeddings[:-1]:
        n_prefix *= e.shape[0]
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    tiles = []
    lowp_dev = None
    # walk statistics, fused into the same prefix sweeps: the last-edge row
    # sums r[i] = sum_c w_last(i, c) (every i in the last prefix table is
    # visited as i_last cycles the prefix cross product, duplicates rewrite
    # identical values) and the chain total sum_t wp(t) * r[i_last(t)]
    r_last = np.zeros(e_prev.shape[0], np.float64)
    total = 0.0
    right = None  # right table padded/quantised once, swept per prefix block
    if use_kernel:
        with span("joinml.sweep.upload"):
            right = prepare_right(e_last, precision=precision, device=device)
    elif precision != "fp32":
        _warn_lowp_unavailable(precision)
    for s in range(0, n_prefix, block):
        wp, i_last = _prefix_chain_weights(
            embeddings, s, min(s + block, n_prefix), exponent, floor
        )
        if use_kernel:
            # kernel bins max(clip(sim), floor)**(e*root) * scale —
            # exactly (wp * w_last)**root when scale = wp**root; the walk
            # sums ride along at the raw full exponent (rs_exponent)
            out = _kernel_sweep(
                e_prev[i_last], None, n_bins, exponent * root, floor,
                scale=wp**root, precision=precision, k_top=1, right=right,
                rs_exponent=exponent, device=device,
            )
            tile = out.counts
            rs_blk = out.row_sums
            if precision != "fp32" and s == 0:
                w = pair_weights(e_prev[i_last], e_last, exponent * root,
                                 floor, device=device)
                ref = _binned_counts(wp[:, None] ** root * w, n_bins)
                dev = lowp_dev = _lowp_cdf_dev(ref, tile)
                if tolerance is not None and dev > tolerance:
                    import warnings

                    warnings.warn(
                        f"{precision} chain sweep CDF deviation {dev:.4f} "
                        f"exceeds tolerance {tolerance:.4f}; using fp32"
                    )
                    info = sweep_pass_chain(
                        embeddings, n_bins, exponent, floor, block,
                        use_kernel, precision="fp32", device=device,
                    )
                    info.stats["lowp_fallback"] = dev
                    return info
        else:
            w = pair_weights(e_prev[i_last], e_last, exponent, floor,
                             device=device)
            rs_blk = w.sum(axis=1)
            v = (wp[:, None] * w) ** root
            c, _ = np.histogram(v, bins=edges)
            tile = c.astype(np.int64)
        total += float(wp @ rs_blk)
        r_last[i_last] = rs_blk
        tiles.append(tile)
    bc = np.stack(tiles) if tiles else np.zeros((1, n_bins), np.int64)
    # the precision label drives blocks_over's safety margin
    used_lowp = use_kernel and precision != "fp32"
    info = SweepInfo(
        counts=bc.sum(axis=0), edges=edges, block_counts=bc, block_rows=block,
        topk=None, kernel=use_kernel,
        precision=precision if used_lowp else "fp32",
    )
    if used_lowp and lowp_dev is not None:
        info.stats["lowp_cdf_dev"] = lowp_dev
    if not used_lowp:
        # earlier edges are small inter-table products (already paid inside
        # the prefix tuple weights); only the last cross-product edge was
        # ever expensive, and its sums were fused above
        from .similarity import edge_row_sums_raw

        info.row_sums = edge_row_sums_raw(embeddings[:-1], exponent,
                                          floor, device=device) + [r_last]
        info.total_weight = total
    return info


def weight_histogram(
    e1: np.ndarray,
    e2: np.ndarray,
    n_bins: int = 4096,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = False,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Two-pass baseline, pass 1: histogram of pair weights over the (never
    materialised) cross product.  Returns (counts[n_bins], edges[n_bins+1])
    with edges spanning [0, 1]."""
    from .similarity import pair_weights  # local import to avoid cycle

    if use_kernel:
        from ..kernels.sim_hist.ops import sim_hist

        return sim_hist(e1, e2, n_bins, exponent, floor, device=device)

    edges = np.linspace(0.0, 1.0, n_bins + 1)
    counts = np.zeros(n_bins, np.int64)
    n1 = e1.shape[0]
    for s in range(0, n1, block):
        w = pair_weights(e1[s : s + block], e2, exponent, floor, device=device)
        c, _ = np.histogram(w, bins=edges)
        counts += c
    return counts, edges


def chain_weight_histogram(
    embeddings: list,
    n_bins: int = 4096,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = False,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Two-pass baseline, pass 1 for k-way chains: histogram of the
    geometric-mean chain weight W(t)**(1/(k-1)), streamed over prefix blocks
    (O(block * Nk) peak memory).  At k=2 this is ``weight_histogram``."""
    from .similarity import pair_weights

    k = len(embeddings)
    if k == 2:
        return weight_histogram(
            embeddings[0], embeddings[1], n_bins, exponent, floor, block,
            use_kernel, device=device,
        )
    root = 1.0 / (k - 1)
    e_prev, e_last = embeddings[-2], embeddings[-1]
    n_prefix = 1
    for e in embeddings[:-1]:
        n_prefix *= e.shape[0]
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    counts = np.zeros(n_bins, np.int64)
    for s in range(0, n_prefix, block):
        wp, i_last = _prefix_chain_weights(
            embeddings, s, min(s + block, n_prefix), exponent, floor
        )
        if use_kernel:
            from ..kernels.sim_hist.ops import sim_hist

            c, _ = sim_hist(e_prev[i_last], e_last, n_bins, exponent * root,
                            floor, scale=wp**root, device=device)
            counts += c
        else:
            w = pair_weights(e_prev[i_last], e_last, exponent, floor,
                             device=device)
            v = (wp[:, None] * w) ** root
            c, _ = np.histogram(v, bins=edges)
            counts += c
    return counts, edges


def threshold_for_top_m(counts: np.ndarray, edges: np.ndarray, m: int) -> float:
    """Largest bin edge t such that #weights >= t is >= m (CDF from the top).

    Edge cases: ``m <= 0`` returns the top edge (collect nothing below the
    maximum representable weight); ``m`` at or beyond the total mass — or an
    all-empty histogram — returns the bottom edge (collect everything)."""
    if m <= 0:
        return float(edges[-1])
    csum = np.cumsum(counts[::-1])[::-1]  # csum[i] = #weights in bins >= i
    ok = np.nonzero(csum >= m)[0]
    if len(ok) == 0:
        return float(edges[0])
    return float(edges[ok[-1]])


def _sim_topk(e1, e2, k, device):
    from ..kernels.sim_topk.ops import sim_topk

    return sim_topk(e1, e2, k=k, device=device)


def _collect_from_topk(e1, e2, vals, idx, valid, threshold, exponent, floor,
                       stats=None, device="cuda"):
    """Over-threshold collection from per-row top-k candidates.

    Any row whose last candidate still clears the threshold may have been
    truncated at the candidate budget; truncated rows get ONE retry at 4x
    the budget (``sim_topk`` with a raised k) and rows that saturate even
    that are rescanned exactly — so no pair is ever silently dropped and
    the full product is never rescanned.  Returns (flat_idx, weights)."""
    from .similarity import weight_of_score

    n1, n2 = e1.shape[0], e2.shape[0]
    kk = vals.shape[1]
    w_vals = weight_of_score(np.asarray(vals, np.float64), exponent, floor)
    keep = (w_vals >= threshold) & valid
    if kk < n2:  # a row's hits may have been truncated at kk candidates
        saturated = np.nonzero(w_vals[:, -1] >= threshold)[0]
    else:
        saturated = np.empty(0, np.int64)
    keep[saturated] = False
    r, c = np.nonzero(keep)
    flat = [r.astype(np.int64) * n2 + idx[r, c]]
    wts = [w_vals[r, c]]
    if len(saturated):
        k2 = min(max(4 * kk, 128), n2)
        # a deep threshold saturates most rows; the retry would likely
        # saturate too, so go straight to the exact rescan
        retry_pays = len(saturated) <= n1 // 4
        if k2 > kk and retry_pays:
            v2, i2, valid2 = _sim_topk(e1[saturated], e2, k2, device)
            w2 = weight_of_score(np.asarray(v2, np.float64), exponent, floor)
            keep2 = (w2 >= threshold) & valid2
            if v2.shape[1] < n2:
                still = np.nonzero(w2[:, -1] >= threshold)[0]
            else:
                still = np.empty(0, np.int64)
            keep2[still] = False
            r2, c2 = np.nonzero(keep2)
            flat.append(saturated[r2].astype(np.int64) * n2 + i2[r2, c2])
            wts.append(w2[r2, c2])
            if stats is not None:
                stats["topk_retry_rows"] = int(len(saturated))
            saturated = saturated[still]
        if stats is not None:
            stats["dense_rescan_rows"] = int(len(saturated))
        if len(saturated):
            rr, cc, w = _over_threshold(e1[saturated], e2, threshold,
                                        exponent, floor, device)
            flat.append(saturated[rr].astype(np.int64) * n2 + cc)
            wts.append(w)
    return np.concatenate(flat), np.concatenate(wts)


def _collect_top_pairs_topk(e1, e2, threshold, exponent, floor, stats=None,
                            device="cuda"):
    """Two-pass baseline: run sim_topk now, then collect (see
    :func:`_collect_from_topk`)."""
    vals, idx, valid = _sim_topk(e1, e2, min(TOPK_CANDIDATES, e2.shape[0]),
                                 device)
    return _collect_from_topk(
        e1, e2, vals, idx, valid, threshold, exponent, floor, stats=stats,
        device=device,
    )


def collect_top(
    e1: np.ndarray,
    e2: np.ndarray,
    threshold: float,
    m_cap: int,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = False,
    sweep: Optional[SweepInfo] = None,
    return_weights: bool = False,
    device="cuda",
):
    """Collect flat indices of pairs with weight >= threshold, sorted by
    weight descending, truncated to m_cap.

    With a :class:`SweepInfo` the candidates come straight from the sweep's
    top-k output (no second kernel pass) and any rescan — truncated rows,
    or the whole collection on the blocked host path — touches only the row
    blocks whose count tiles show over-threshold mass."""
    n1, n2 = e1.shape[0], e2.shape[0]
    stats = sweep.stats if sweep is not None else None
    if m_cap < 16 * n1:
        out = None
        if sweep is not None and sweep.topk is not None:
            vals, idx, valid = sweep.topk
            out = _collect_from_topk(
                e1, e2, vals, idx, valid, threshold, exponent, floor,
                stats=stats, device=device,
            )
        elif use_kernel:
            out = _collect_top_pairs_topk(e1, e2, threshold, exponent, floor,
                                          stats=stats, device=device)
        if out is not None:
            idx, w = out
            order = np.argsort(w)[::-1][:m_cap]
            if return_weights:
                return idx[order], w[order]
            return idx[order]

    idx_chunks, w_chunks = [], []
    if sweep is not None:
        starts, step = sweep.rescan_starts(threshold, n1)
    else:
        starts, step = list(range(0, n1, block)), block
    for s in starts:
        r, c, w = _over_threshold(e1[s : s + step], e2, threshold, exponent,
                                  floor, device)
        idx_chunks.append(((r + s).astype(np.int64) * n2 + c))
        w_chunks.append(w)
    idx = np.concatenate(idx_chunks) if idx_chunks else np.empty(0, np.int64)
    w = np.concatenate(w_chunks) if w_chunks else np.empty(0, np.float64)
    order = np.argsort(w)[::-1][:m_cap]
    if return_weights:
        return idx[order], w[order]
    return idx[order]


def collect_top_chain(
    embeddings: list,
    threshold_root: float,
    m_cap: int,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = False,
    sweep: Optional[SweepInfo] = None,
    return_weights: bool = False,
    device="cuda",
):
    """Flat indices (over the full k-way cross product, row-major) of tuples
    whose geometric-mean chain weight clears ``threshold_root``, sorted by
    chain weight descending, truncated to m_cap.  With a chain sweep, prefix
    blocks whose count tiles show no over-threshold mass are skipped."""
    k = len(embeddings)
    if k == 2:
        return collect_top(
            embeddings[0], embeddings[1], threshold_root, m_cap, exponent,
            floor, block, use_kernel, sweep=sweep,
            return_weights=return_weights, device=device,
        )
    thr_w = threshold_root ** (k - 1)  # back to raw chain-weight space
    e_prev, e_last = embeddings[-2], embeddings[-1]
    n_last = e_last.shape[0]
    n_prefix = 1
    for e in embeddings[:-1]:
        n_prefix *= e.shape[0]
    if sweep is not None:
        starts, step = sweep.rescan_starts(threshold_root, n_prefix)
    else:
        starts, step = list(range(0, n_prefix, block)), block
    idx_chunks, w_chunks = [], []
    for s in starts:
        wp, i_last = _prefix_chain_weights(
            embeddings, s, min(s + step, n_prefix), exponent, floor
        )
        r, c, w = _over_threshold(e_prev[i_last], e_last, thr_w, exponent,
                                  floor, device, row_weight=wp)
        idx_chunks.append((r + s).astype(np.int64) * n_last + c)
        w_chunks.append(w)
    idx = np.concatenate(idx_chunks) if idx_chunks else np.empty(0, np.int64)
    w = np.concatenate(w_chunks) if w_chunks else np.empty(0, np.float64)
    order = np.argsort(w)[::-1][:m_cap]
    if return_weights:
        return idx[order], w[order]
    return idx[order]


def stratify_streaming_chain(
    embeddings: list,
    alpha: float,
    budget: int,
    cfg: BASConfig,
    n_bins: int = 4096,
    use_kernel: bool = False,
    use_sweep: Optional[bool] = None,
    precision: Optional[str] = None,
    artifact=None,
    device="cuda",
) -> Stratification:
    """Histogram-thresholded stratification of a k-way chain; equal-size
    strata like the dense path but the threshold (hence membership at the
    boundary) is bin-resolution approximate.  Strata remain exactly
    equal-sized; only *which* borderline tuples land in D_K vs D_0 can differ
    — the estimator stays unbiased because stratum membership is
    deterministic given the data.

    ``use_sweep`` (default from ``cfg.use_sweep``) runs the fused
    single-sweep path; ``use_sweep=False`` keeps the two-pass
    histogram-then-collect baseline, which is bit-identical at fp32.
    ``precision`` opts the sweep into the bf16/int8 fast path (default from
    ``cfg.sweep_precision``), tolerance-gated via ``cfg.sweep_tolerance``.
    ``artifact`` (:class:`repro_torch.core.index.IndexArtifact`) hydrates a
    persisted sweep instead of computing one — threshold selection and
    collection run unchanged against the loaded tiles/top-k."""
    resolve_device(device)
    if use_sweep is None:
        use_sweep = cfg.use_sweep
    if precision is None:
        precision = cfg.sweep_precision
    n = 1
    for e in embeddings:
        n *= e.shape[0]
    m = min(int(round(alpha * budget)), n)
    k = auto_num_strata(alpha, budget, cfg)
    k = max(1, min(k, m)) if m > 0 else 0
    if m == 0:
        return Stratification(np.empty(0, np.int64), np.zeros(1, np.int64), n)
    sweep = None
    if artifact is not None:
        sweep = sweep_pass_chain(
            embeddings, n_bins, cfg.weight_exponent, cfg.weight_floor,
            artifact=artifact, device=device,
        )
        counts, edges = sweep.counts, sweep.edges
    elif use_sweep:
        # collection only consults the top-k when the blocking regime is
        # sparse per row (see collect_top); otherwise skip its epilogue cost
        n1 = embeddings[0].shape[0]
        k_top = TOPK_CANDIDATES if (len(embeddings) == 2 and m < 16 * n1) else 1
        sweep = sweep_pass_chain(
            embeddings, n_bins, cfg.weight_exponent, cfg.weight_floor,
            use_kernel=use_kernel, precision=precision,
            tolerance=cfg.sweep_tolerance, k_top=k_top, device=device,
        )
        counts, edges = sweep.counts, sweep.edges
    else:
        counts, edges = chain_weight_histogram(
            embeddings, n_bins, cfg.weight_exponent, cfg.weight_floor,
            use_kernel=use_kernel, device=device,
        )
    with span("joinml.collect"):
        thr = threshold_for_top_m(counts, edges, m)
        order, order_w = collect_top_chain(
            embeddings, thr, m, cfg.weight_exponent, cfg.weight_floor,
            use_kernel=use_kernel, sweep=sweep, return_weights=True,
            device=device,
        )
    m_eff = len(order)
    k = max(1, min(k, m_eff))
    bounds = np.round(np.linspace(0, m_eff, k + 1)).astype(np.int64)
    return Stratification(
        order=order, bounds=bounds, n_total=n, order_weights=order_w,
        sweep=sweep,
    )


def stratify_streaming(
    e1: np.ndarray,
    e2: np.ndarray,
    alpha: float,
    budget: int,
    cfg: BASConfig,
    n_bins: int = 4096,
    use_kernel: bool = False,
    use_sweep: Optional[bool] = None,
    precision: Optional[str] = None,
    artifact=None,
    device="cuda",
) -> Stratification:
    """Two-table wrapper of :func:`stratify_streaming_chain`."""
    return stratify_streaming_chain(
        [e1, e2], alpha, budget, cfg, n_bins=n_bins, use_kernel=use_kernel,
        use_sweep=use_sweep, precision=precision, artifact=artifact,
        device=device,
    )
