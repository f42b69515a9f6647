"""Persistent stratification index: build-once/query-many sweep artifacts.

The stratification sweep — one blocked pass over ``E1 @ E2^T`` (see
``stratify.sweep_pass``) — is a pure function of (tables, embedder config,
binning), yet it is the largest device work on the query path and is
recomputed from scratch on every query, including repeat and concurrent
queries on the same hot table pair.  This module turns the sweep's outputs
into a reusable **index artifact**:

* :class:`IndexArtifact` — everything a query needs to stratify without
  touching the cross product: the embeddings, the global weight histogram,
  the per-(row-block, bin) count tiles, the per-row top-k candidates, the
  fused walk sums, and the binning/precision metadata, under a
  **content-addressed key** (SHA-256 over the table fingerprints +
  embedder/binning config, the same key the reference package derives).
  Hydrating it (:meth:`IndexArtifact.sweep_info`) yields a
  :class:`~repro_torch.core.stratify.SweepInfo` that the threshold /
  collection / rescan machinery consumes unchanged — bit-identical at fp32
  to a freshly computed sweep, because the artifact *is* that sweep's output.
* :func:`build_index` — one cold sweep (the same ``sweep_pass_chain`` the
  per-query path runs, with the full top-k budget so any later query shape
  can use it).
* :func:`append_rows` — **incremental maintenance**: appending rows to
  either table sweeps only the new row/column blocks and composes the count
  tiles by exact integer addition (the tiles are histograms, so disjoint
  row regions add; new columns add per tile), merges the per-row top-k, and
  bumps the artifact ``version`` so stale readers detect drift.  Cost is
  proportional to the delta, never the table.
* :class:`IndexStore` — a service-resident LRU (bounded by memory budget)
  mapping content keys to loaded artifacts, so concurrent queries through
  ``JoinMLEngine`` share one artifact per table pair.  Misses fall through
  to an on-disk root (``checkpoint.index_io``) before building.

Device: the sweeps of :func:`build_index`, :func:`append_rows` and the
store's builds run on ``device`` (default ``"cuda"``: the sweep kernels;
raises without a card; ``"cpu"`` runs their plain PyTorch versions).  The
artifact itself stays numpy on the host — mmapped after a load — and the
statistics stay f64 numpy.

Persistence (atomic save / mmap load) lives in
``repro_torch.checkpoint.index_io``; the engine integration
(``method="auto"`` routing through a fresh artifact) in ``core.dispatch``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Optional

import numpy as np

from ..device import host_f32, resolve_device
from .stratify import TOPK_CANDIDATES, SweepInfo, sweep_pass, sweep_pass_chain

INDEX_FORMAT = 2   # bump when the artifact/on-disk layout changes
# format history:
#   1 — counts/edges/block_counts/embeddings/topk
#   2 — + per-edge walk row_sums and chain total_weight (one-pass chain
#       statistics: warm queries sample without re-reading the product)


def table_fingerprint(emb: np.ndarray) -> str:
    """Content hash of one table's embeddings (shape + f32 bytes).  The
    sweep consumes float32, so fingerprinting the f32 view makes the key
    insensitive to the caller's incidental dtype."""
    arr = np.ascontiguousarray(np.asarray(emb, np.float32))
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def artifact_key(
    embeddings: list,
    n_bins: int,
    exponent: float,
    floor: float,
    precision: str = "fp32",
) -> str:
    """Content-addressed identity of a sweep artifact: the table
    fingerprints plus everything that changes the tiles' *values*
    (binning resolution, weight transform, requested sweep precision).
    Execution details that only change the layout (kernel vs blocked host
    path, block size, top-k width, device) are deliberately excluded — they
    never change what a hydrated query computes, only how much a rescan can
    skip."""
    payload = {
        "format": INDEX_FORMAT,
        "tables": [table_fingerprint(e) for e in embeddings],
        "n_bins": int(n_bins),
        "exponent": float(exponent),
        "floor": float(floor),
        "precision": str(precision),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()


@dataclasses.dataclass
class IndexArtifact:
    """A stored sweep: stratification inputs for one (tables, embedder,
    binning) identity.  Arrays may be disk mmaps (read-only) — every
    consumer treats them as immutable; maintenance returns a new artifact.

    ``precision`` is the *effective* tile precision (what the sweep
    actually binned at — the blocked host path computes fp32 even when a
    low precision was requested); ``precision_requested`` is what the key
    was derived from, so repeat queries with the same config keep
    hitting."""

    key: str
    version: int
    sizes: tuple               # per-table row counts
    n_bins: int
    exponent: float
    floor: float
    precision: str             # effective tile precision
    precision_requested: str   # key component
    kernel: bool               # built through the sweep kernel
    block_rows: int
    counts: np.ndarray         # (n_bins,) i64 — exact column sum of tiles
    edges: np.ndarray          # (n_bins + 1,)
    block_counts: np.ndarray   # (n_blocks, n_bins) i64
    embeddings: list           # per-table (N_i, d) f32
    topk_vals: Optional[np.ndarray] = None   # (N1, k) f32 clipped scores
    topk_idx: Optional[np.ndarray] = None    # (N1, k) i32 right-row indices
    topk_valid: Optional[np.ndarray] = None  # (N1, k) bool
    row_sums: Optional[list] = None          # per-edge (N_j,) f64 walk sums
    total_weight: Optional[float] = None     # chain total sum_t prod_j w_j
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def n_tables(self) -> int:
        return len(self.sizes)

    @property
    def nbytes(self) -> int:
        arrays = [self.counts, self.edges, self.block_counts, *self.embeddings]
        if self.topk_vals is not None:
            arrays += [self.topk_vals, self.topk_idx, self.topk_valid]
        if self.row_sums is not None:
            arrays += list(self.row_sums)
        return int(sum(a.nbytes for a in arrays))

    def check(self, sizes=None, n_bins=None, exponent=None, floor=None):
        """Raise if the artifact cannot serve the given stratify config."""
        if sizes is not None and tuple(sizes) != tuple(self.sizes):
            raise ValueError(
                f"index artifact covers tables {self.sizes}, query has "
                f"{tuple(sizes)} — refresh the index (append_rows) first"
            )
        for name, got, want in (
            ("n_bins", n_bins, self.n_bins),
            ("exponent", exponent, self.exponent),
            ("floor", floor, self.floor),
        ):
            if got is not None and got != want:
                raise ValueError(
                    f"index artifact {name}={want} incompatible with "
                    f"requested {name}={got}"
                )

    def sweep_info(self) -> SweepInfo:
        """Hydrate a fresh :class:`SweepInfo` (the stats dict is per-query
        mutable state, so every hydration gets its own)."""
        topk = None
        if self.topk_vals is not None:
            topk = (self.topk_vals, self.topk_idx, self.topk_valid)
        stats = dict(self.stats.get("sweep", {}))
        stats["index_version"] = self.version
        return SweepInfo(
            counts=self.counts, edges=self.edges,
            block_counts=self.block_counts, block_rows=self.block_rows,
            topk=topk, kernel=self.kernel, precision=self.precision,
            stats=stats, row_sums=self.row_sums,
            total_weight=self.total_weight,
        )


def build_index(
    embeddings: list,
    n_bins: int = 4096,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    use_kernel: bool = True,
    precision: str = "fp32",
    tolerance: Optional[float] = None,
    device="cuda",
) -> IndexArtifact:
    """One cold sweep over the (chain) product on ``device``, packaged as
    an artifact.

    Built with the full per-row top-k budget (``TOPK_CANDIDATES``) so any
    later query can hydrate regardless of its blocking-regime size; queries
    whose regime is dense simply ignore the top-k — exactly as the fresh
    path ignores it by sweeping with ``k_top=1``.
    """
    resolve_device(device)
    embeddings = [host_f32(e) for e in embeddings]
    t0 = time.perf_counter()
    info = sweep_pass_chain(
        embeddings, n_bins, exponent, floor, block=block,
        use_kernel=use_kernel, precision=precision, tolerance=tolerance,
        k_top=TOPK_CANDIDATES, device=device,
    )
    build_s = time.perf_counter() - t0
    vals = idx = valid = None
    if info.topk is not None:
        vals, idx, valid = (np.asarray(a) for a in info.topk)
    return IndexArtifact(
        key=artifact_key(embeddings, n_bins, exponent, floor, precision),
        version=1,
        sizes=tuple(int(e.shape[0]) for e in embeddings),
        n_bins=n_bins,
        exponent=float(exponent),
        floor=float(floor),
        precision=info.precision,
        precision_requested=precision,
        kernel=info.kernel,
        block_rows=info.block_rows,
        counts=np.asarray(info.counts, np.int64),
        edges=np.asarray(info.edges),
        block_counts=np.asarray(info.block_counts, np.int64),
        embeddings=embeddings,
        topk_vals=vals, topk_idx=idx, topk_valid=valid,
        row_sums=info.row_sums, total_weight=info.total_weight,
        stats={"build_s": build_s, "appends": 0, "delta_blocks": 0,
               "delta_rows": 0, "sweep": dict(info.stats)},
    )


def _regroup_tiles(bc: np.ndarray, from_rows: int, to_rows: int) -> np.ndarray:
    """Re-aggregate count tiles from a finer uniform row stride to a coarser
    one (exact integer addition; strides must nest)."""
    if from_rows == to_rows:
        return np.asarray(bc, np.int64)
    if to_rows % from_rows != 0:
        raise ValueError(f"tile strides do not nest: {from_rows} -> {to_rows}")
    factor = to_rows // from_rows
    cuts = np.arange(0, bc.shape[0], factor)
    return np.add.reduceat(np.asarray(bc, np.int64), cuts, axis=0)


def _sweep_rows(e_rows, e2, art: IndexArtifact, use_kernel: bool,
                k_top: int, device) -> SweepInfo:
    """Sweep a row region against the full right table under the artifact's
    binning config, at the artifact's tile stride (``kernel_block``), so
    the delta tiles nest into the stored ones whatever launch built them.
    Low-precision tiles must come from the kernel path (the blocked host
    path computes fp32, which would silently mix precisions inside one
    artifact); tolerance inf disables the lowp re-check — the build already
    certified this table pair."""
    info = sweep_pass(
        e_rows, e2, art.n_bins, art.exponent, art.floor,
        block=art.block_rows, use_kernel=use_kernel, precision=art.precision,
        tolerance=float("inf"), k_top=k_top, kernel_block=art.block_rows,
        device=device,
    )
    if art.precision != "fp32" and info.precision != art.precision:
        raise RuntimeError(
            f"cannot maintain a {art.precision} index without the sweep "
            "kernel path — rebuild at fp32 or restore the kernel"
        )
    return info


def append_rows(
    art: IndexArtifact,
    table: int,
    new_rows: np.ndarray,
    use_kernel: bool = True,
    device="cuda",
) -> IndexArtifact:
    """Incrementally maintain a two-table artifact after appending
    ``new_rows`` to table ``table`` (0 = left/rows, 1 = right/columns); the
    delta sweeps run on ``device``.  Returns a NEW artifact (version
    bumped, key re-derived from the grown tables); the input artifact —
    possibly a read-only mmap — is untouched.

    Exactness: the count tiles are integer histograms, so

    * **left append** re-sweeps only the row region from the last aligned
      block boundary down (the one partial tile plus the new rows) and
      concatenates the new tiles — every untouched tile is byte-identical
      to a full recompute's;
    * **right append** sweeps the full left table against only the new
      columns and adds the delta tiles tile-wise (disjoint column ranges
      of a histogram add exactly); the per-row top-k merges the stored
      candidates with the delta's (ties break toward the lower column
      index, matching the kernel's ties-to-the-lower-column top-k).

    Both sweep only the delta, never the table; the host work is not all
    delta-sized: the new key re-hashes both tables, and a right append
    merges every left row's top-k list.
    """
    if art.n_tables != 2:
        raise NotImplementedError(
            "incremental maintenance covers two-table artifacts; rebuild "
            "chain indexes with build_index"
        )
    if table not in (0, 1):
        raise ValueError(f"table must be 0 or 1, got {table}")
    resolve_device(device)
    new_rows = host_f32(new_rows)
    if new_rows.ndim != 2 or new_rows.shape[1] != art.embeddings[table].shape[1]:
        raise ValueError(
            f"new rows {new_rows.shape} do not extend table {table} "
            f"{art.embeddings[table].shape}"
        )
    e1, e2 = (host_f32(e) for e in art.embeddings)
    br = art.block_rows
    stats = dict(art.stats)
    stats["appends"] = int(stats.get("appends", 0)) + 1
    stats["delta_rows"] = int(stats.get("delta_rows", 0)) + len(new_rows)
    has_topk = art.topk_vals is not None
    k_top = TOPK_CANDIDATES if has_topk else 1

    if table == 0:
        n1_old = e1.shape[0]
        e1_new = np.ascontiguousarray(np.concatenate([e1, new_rows]))
        # recompute from the last aligned block boundary: at most one
        # existing (partial) tile is replaced, the rest are appended.  Each
        # br-row chunk is swept separately and its global histogram IS that
        # region's tile (the chunk may internally tile finer; counts is the
        # exact integer sum of its sub-tiles).
        start = (n1_old // br) * br
        tiles, tops, region_sums = [], [], []
        for cs in range(start, e1_new.shape[0], br):
            info = _sweep_rows(e1_new[cs : cs + br], e2, art, use_kernel,
                               k_top, device)
            tiles.append(np.asarray(info.counts, np.int64))
            tops.append(info.topk)
            region_sums.append(None if info.row_sums is None
                               else info.row_sums[0])
        block_counts = np.concatenate(
            [np.asarray(art.block_counts[: start // br], np.int64),
             np.stack(tiles)]
        )
        delta_blocks = len(tiles)
        topk_vals = topk_idx = topk_valid = None
        if has_topk and all(t is not None for t in tops):
            tail_v = np.concatenate([np.asarray(t[0]) for t in tops])
            tail_i = np.concatenate([np.asarray(t[1]) for t in tops])
            tail_ok = np.concatenate([np.asarray(t[2]) for t in tops])
            # rows [start, n1_old) were re-swept inside the region; their
            # fresh top-k equals the stored one, so either slice works —
            # keep the stored prefix and take only genuinely new rows
            keep = n1_old - start
            topk_vals = np.concatenate(
                [np.asarray(art.topk_vals[:n1_old]), tail_v[keep:]]
            )
            topk_idx = np.concatenate(
                [np.asarray(art.topk_idx[:n1_old]), tail_i[keep:]]
            )
            topk_valid = np.concatenate(
                [np.asarray(art.topk_valid[:n1_old]), tail_ok[keep:]]
            )
        row_sums = total_weight = None
        if art.row_sums is not None and all(s is not None for s in region_sums):
            # new left rows add their own walk sums; the re-swept overlap
            # [start, n1_old) is replaced by its (deterministically equal)
            # recomputation — total updated in O(delta), never re-reduced
            old_rs = np.asarray(art.row_sums[0], np.float64)
            tail_rs = np.concatenate(region_sums)
            row_sums = [np.concatenate([old_rs[:start], tail_rs])]
            total_weight = float(
                art.total_weight - old_rs[start:].sum() + tail_rs.sum()
            )
        embeddings = [e1_new, e2]
    else:
        n2_old = e2.shape[0]
        e2_new = np.ascontiguousarray(np.concatenate([e2, new_rows]))
        info = _sweep_rows(e1, new_rows, art, use_kernel, k_top, device)
        delta = _regroup_tiles(info.block_counts, info.block_rows, br)
        if delta.shape != art.block_counts.shape:
            raise RuntimeError(
                f"delta tiles {delta.shape} misaligned with index tiles "
                f"{art.block_counts.shape}"
            )
        block_counts = np.asarray(art.block_counts, np.int64) + delta
        delta_blocks = int(delta.shape[0])
        topk_vals = topk_idx = topk_valid = None
        if has_topk and info.topk is not None:
            topk_vals, topk_idx, topk_valid = _merge_topk(
                (art.topk_vals, art.topk_idx, art.topk_valid),
                info.topk, n2_old, e2_new.shape[0],
            )
        row_sums = total_weight = None
        if art.row_sums is not None and info.row_sums is not None:
            # the delta sweep's sums are each left row's mass over the new
            # columns only — elementwise add, O(N1) like the delta tiles
            delta_rs = np.asarray(info.row_sums[0], np.float64)
            row_sums = [np.asarray(art.row_sums[0], np.float64) + delta_rs]
            total_weight = float(art.total_weight + delta_rs.sum())
        embeddings = [e1, e2_new]

    stats["delta_blocks"] = int(stats.get("delta_blocks", 0)) + delta_blocks
    stats["last_delta_blocks"] = delta_blocks
    return IndexArtifact(
        key=artifact_key(embeddings, art.n_bins, art.exponent, art.floor,
                         art.precision_requested),
        version=art.version + 1,
        sizes=tuple(int(e.shape[0]) for e in embeddings),
        n_bins=art.n_bins, exponent=art.exponent, floor=art.floor,
        precision=art.precision,
        precision_requested=art.precision_requested,
        kernel=art.kernel, block_rows=br,
        counts=block_counts.sum(axis=0),
        edges=np.asarray(art.edges),
        block_counts=block_counts,
        embeddings=embeddings,
        topk_vals=topk_vals, topk_idx=topk_idx, topk_valid=topk_valid,
        row_sums=row_sums, total_weight=total_weight,
        stats=stats,
    )


def _merge_topk(old: tuple, new: tuple, n2_old: int, n2_total: int) -> tuple:
    """Per-row merge of stored top-k with a new-columns top-k (delta column
    indices shifted by ``n2_old``).  Invalid slots are neutralised to
    ``(-1, n2_total)`` so they sort last and stay invalid; ties break
    toward the lower column index (the kernel's convention)."""
    ov, oi, ok = (np.asarray(a) for a in old)
    nv, ni, nk = (np.asarray(a) for a in new)
    vals = np.concatenate(
        [np.where(ok, ov, -1.0), np.where(nk, nv, -1.0)], axis=1
    ).astype(np.float32)
    idx = np.concatenate(
        [np.where(ok, oi.astype(np.int64), n2_total),
         np.where(nk, ni.astype(np.int64) + n2_old, n2_total)], axis=1
    )
    k = ov.shape[1]
    order = np.lexsort((idx, -vals.astype(np.float64)), axis=-1)[:, :k]
    rows = np.arange(vals.shape[0])[:, None]
    vals_m, idx_m = vals[rows, order], idx[rows, order]
    valid = idx_m < n2_total
    return (
        np.where(valid, vals_m, 0.0).astype(np.float32),
        np.where(valid, idx_m, n2_total).astype(np.int32),
        valid,
    )


# ----------------------------------------------------------------------------
# Service-resident store: one loaded artifact per hot table pair.
# ----------------------------------------------------------------------------


class IndexStore:
    """Thread-safe LRU of :class:`IndexArtifact`\\ s keyed by content
    address, bounded by ``max_bytes``.  Concurrent first queries on the
    same key share one build (per-key future): the first caller builds on
    its own thread, on ``device``, and the others block on the future;
    distinct keys build in parallel.  With ``root`` set, a memory miss
    tries the on-disk store (``checkpoint.index_io``, mmap load) before
    paying a cold sweep, and the launch autotuner keeps its cache in
    ``<root>/autotune.json`` (``kernels.autotune``: tuning on).
    """

    def __init__(self, max_bytes: int = 1 << 30, root: Optional[str] = None,
                 tracker=None, device="cuda"):
        from ..obs import NULL_TRACKER

        self.device = resolve_device(device)
        self.max_bytes = int(max_bytes)
        self.root = root
        if root is not None:
            # tuned launch parameters live next to the artifacts they
            # accelerate (configure() only records the path; nothing is
            # measured until a sweep launches on the card)
            from ..kernels import autotune

            autotune.configure(os.path.join(os.fspath(root), "autotune.json"))
        self.tracker = tracker if tracker is not None else NULL_TRACKER
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Future]" = OrderedDict()
        self._sizes: dict = {}
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.loads = 0
        self.evictions = 0
        self.build_ms = 0.0
        self.delta_blocks = 0

    # ---- lookups -----------------------------------------------------------

    def key_for(self, embeddings, n_bins=4096, exponent=1.0, floor=1e-3,
                precision="fp32") -> str:
        return artifact_key(embeddings, n_bins, exponent, floor, precision)

    def lookup(self, embeddings, **params) -> Optional[IndexArtifact]:
        """A *fresh* resident artifact for these exact tables, or None —
        never builds, never counts a miss.  Freshness is structural: the
        content key is derived from the live embeddings, so a stale
        (pre-append) artifact simply no longer matches."""
        key = self.key_for(embeddings, **params)
        with self._lock:
            fut = self._entries.get(key)
            if fut is None or not fut.done() or fut.exception() is not None:
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return fut.result()

    def get_or_build(
        self,
        embeddings,
        n_bins: int = 4096,
        exponent: float = 1.0,
        floor: float = 1e-3,
        precision: str = "fp32",
        use_kernel: bool = True,
        block: int = 4096,
    ) -> tuple:
        """Returns ``(artifact, hit)``.  ``hit`` is True when the artifact
        was already resident — including waiting on another query's
        in-flight build of the same key."""
        key = artifact_key(embeddings, n_bins, exponent, floor, precision)
        with self._lock:
            fut = self._entries.get(key)
            if fut is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                owner = False
            else:
                fut = Future()
                self._entries[key] = fut
                self.misses += 1
                owner = True
        if not owner:
            return fut.result(), True
        try:
            art = self._load_from_root(key)
            if art is None:
                t0 = time.perf_counter()
                art = build_index(
                    embeddings, n_bins=n_bins, exponent=exponent, floor=floor,
                    block=block, use_kernel=use_kernel, precision=precision,
                    device=self.device,
                )
                dt_ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.builds += 1
                    self.build_ms += dt_ms
        except BaseException as e:
            with self._lock:
                self._entries.pop(key, None)
            fut.set_exception(e)
            raise
        fut.set_result(art)
        self._admit(key, art)
        return art, False

    def add(self, art: IndexArtifact) -> None:
        """Insert an externally built/refreshed artifact (e.g. after
        :func:`append_rows`), accounting its delta in the store counters."""
        fut = Future()
        fut.set_result(art)
        with self._lock:
            self._entries[art.key] = fut
            self._entries.move_to_end(art.key)
            self.delta_blocks += int(art.stats.get("last_delta_blocks", 0))
        self._admit(art.key, art)

    # ---- internals ---------------------------------------------------------

    def _load_from_root(self, key: str) -> Optional[IndexArtifact]:
        if self.root is None:
            return None
        from ..checkpoint.index_io import load_index

        try:
            art = load_index(self.root, key=key)
        except FileNotFoundError:
            return None
        with self._lock:
            self.loads += 1
        return art

    def _admit(self, key: str, art: IndexArtifact) -> None:
        with self._lock:
            self._sizes[key] = art.nbytes
            total = sum(self._sizes.values())
            for old_key in list(self._entries):
                if total <= self.max_bytes:
                    break
                if old_key == key:
                    continue            # never evict what we just admitted
                fut = self._entries[old_key]
                if not fut.done():
                    continue            # never evict an in-flight build
                del self._entries[old_key]
                total -= self._sizes.pop(old_key, 0)
                self.evictions += 1
                self.tracker.count("index_store.evictions")

    # ---- observability -----------------------------------------------------

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return sum(self._sizes.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "index_hit": self.hits,
                "index_miss": self.misses,
                "index_build": self.builds,
                "index_load": self.loads,
                "index_evict": self.evictions,
                "index_build_ms": round(self.build_ms, 2),
                "index_bytes": sum(self._sizes.values()),
                "delta_blocks": self.delta_blocks,
            }

    def snapshot(self) -> dict[str, float]:
        """Unified stats surface: ``index_store.*`` namespaced floats."""
        stats = self.stats()
        return {
            "index_store.warm_hits": float(stats["index_hit"]),
            "index_store.misses": float(stats["index_miss"]),
            "index_store.builds": float(stats["index_build"]),
            "index_store.loads": float(stats["index_load"]),
            "index_store.evictions": float(stats["index_evict"]),
            "index_store.build_ms": float(stats["index_build_ms"]),
            "index_store.bytes": float(stats["index_bytes"]),
            "index_store.delta_blocks": float(stats["delta_blocks"]),
        }
