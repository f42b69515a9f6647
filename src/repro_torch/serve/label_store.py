"""Service-resident shared label store: charge-once caching across queries.

Oracle labels are pure functions of (tuple indices, scorer), yet every query
keeps a *private* sorted flat-index cache (``repro_torch.core.oracle``), so
concurrent and repeat queries on hot table pairs re-pay the ML oracle for
identical pairs — exactly the pairwise-execution cost the paper's BaS design
exists to avoid. :class:`LabelStore` promotes that per-query cache into a
communal, service-scoped one: the
:class:`~repro_torch.serve.oracle_service.OracleService` window planner
dedupes each plan's uncached keys against the store **before any ledger is
charged**, serves hits from memory at commit time, and writes misses back
after a successful backend round trip.

Segments
--------
Labels live in *segments* keyed by ``(service_group(), encoding)``.  The
service-group part guarantees two oracles share a segment only when their
``_label`` is the same pure function (same served scorer + threshold, or the
same wire group); the encoding part — ``("sizes", s1, ..., sk)`` for
bound oracles, ``("pack", k, bits)`` for the unbound bit-packing — guarantees
their int64 flat keys mean the same tuples.  Keys whose service group is
:data:`~repro_torch.core.oracle.PROCESS_LOCAL` (id()-derived, meaningless
in another process) still coalesce in memory but are never persisted.

Charge-once budget policy
-------------------------
A store-served label is *acquired* but not *executed*: the requesting
oracle's ``calls`` counter (which paces the BAS pipeline and meters the
user-facing budget guarantee) advances exactly as in serial execution — so
estimates stay bit-identical — while its ``charged`` counter (backend
executions actually paid for) does not.  The first requester of a pair pays
(``charged`` += misses); every later or concurrent requester rides for free
(``store_hits``/``store_charge_saved`` in ``QueryResult.detail["oracle"]``).
Summed over a workload, total charges equal the store's unique-miss count —
at most the number of distinct pairs ever labelled.

In-flight coalescing
--------------------
:meth:`plan` atomically classifies keys as **hit** (resident — values
captured immediately, so later eviction cannot fail the window), **wait**
(reserved by another in-flight plan — the waiter shares that plan's
``token`` future and its single backend call), or **miss** (this caller
reserves them and must :meth:`publish` or :meth:`cancel`).  Two windows —
even from two services sharing one store — racing on the same uncached pair
therefore trigger exactly one backend call.

Memory budget
-------------
``max_bytes`` bounds residency with LRU *segment* eviction, mirroring the
``IndexStore`` idiom (never the segment just touched, never one with
in-flight reservations).  Because one hot scorer group is the common case,
a lone over-budget segment additionally self-trims its oldest-inserted half
(``store_trimmed``) — so the budget holds even with a single segment.

Persistence
-----------
With ``root`` set, stable segments are written via
``repro_torch.checkpoint.label_io`` (atomic tmp + ``os.replace``,
self-verifying meta.json — the same posture as the stratification index
store) by :meth:`save`, and loaded back at construction, so a service
restart keeps its hot labels. ``OracleService.close()`` saves automatically.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.oracle import PROCESS_LOCAL


def pack_tuples(idx: np.ndarray) -> Optional[np.ndarray]:
    """(n, k) tuple indices -> (n,) int64 keys under the fixed ``63 // k``-bit
    packing (the unbound :class:`~repro_torch.core.oracle.Oracle` encoding),
    or ``None`` when some index does not fit — the caller then skips the store
    for that segment instead of colliding keys."""
    idx = np.asarray(idx)
    n, k = idx.shape
    bits = 63 // k
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= (1 << bits)):
        return None
    keys = np.zeros(n, np.int64)
    for j in range(k):
        keys = (keys << bits) | idx[:, j].astype(np.int64)
    return keys


def unpack_tuples(keys: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_tuples` for the rows a raw segment must still
    execute."""
    bits = 63 // k
    mask = (1 << bits) - 1
    keys = np.asarray(keys, np.int64)
    cols = [(keys >> (bits * (k - 1 - j))) & mask for j in range(k)]
    return np.stack(cols, axis=1).astype(np.int64)


def _flatten(obj):
    if isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _flatten(x)
    else:
        yield obj


def persistable_key(key) -> bool:
    """True when a segment key survives a restart: built purely from
    str/int/float/bool and free of the :data:`PROCESS_LOCAL` marker that
    tags id()-derived (per-process) service groups."""
    parts = list(_flatten(key))
    if any(p == PROCESS_LOCAL for p in parts if isinstance(p, str)):
        return False
    return all(isinstance(p, (str, int, float, bool)) for p in parts)


class _StoreSegment:
    """One service group's resident labels: sorted int64 keys, aligned float64
    values, per-entry insertion generations (for oldest-first trimming), and
    the in-flight reservation map ``pending: key -> owning plan's token``."""

    __slots__ = ("keys", "vals", "gens", "pending")

    def __init__(self):
        self.keys = np.empty(0, np.int64)
        self.vals = np.empty(0, np.float64)
        self.gens = np.empty(0, np.int64)
        self.pending: dict[int, Future] = {}

    @property
    def nbytes(self) -> int:
        return self.keys.nbytes + self.vals.nbytes + self.gens.nbytes

    def resident_mask(self, keys: np.ndarray) -> tuple:
        pos = np.searchsorted(self.keys, keys)
        in_range = pos < len(self.keys)
        hit = np.zeros(len(keys), bool)
        hit[in_range] = self.keys[pos[in_range]] == keys[in_range]
        return hit, pos

    def merge(self, keys: np.ndarray, vals: np.ndarray, gen: int) -> int:
        """Insert (key, val) pairs not already resident; returns how many."""
        hit, _ = self.resident_mask(keys)
        keys, vals = keys[~hit], vals[~hit]
        if not len(keys):
            return 0
        merged_k = np.concatenate([self.keys, keys])
        merged_v = np.concatenate([self.vals, vals])
        merged_g = np.concatenate([self.gens, np.full(len(keys), gen, np.int64)])
        order = np.argsort(merged_k, kind="stable")
        self.keys, self.vals, self.gens = (
            merged_k[order], merged_v[order], merged_g[order]
        )
        return len(keys)

    def trim_oldest_half(self) -> int:
        """Drop the oldest-inserted half of the entries (keys stay sorted)."""
        n = len(self.keys)
        n_drop = max(n // 2, 1)
        order = np.argsort(self.gens, kind="stable")
        keep = np.ones(n, bool)
        keep[order[:n_drop]] = False
        self.keys, self.vals, self.gens = (
            self.keys[keep], self.vals[keep], self.gens[keep]
        )
        return n_drop


@dataclass
class StorePlan:
    """One atomic store consultation (see :meth:`LabelStore.plan`).

    ``hit_keys``/``hit_vals`` are served immediately; ``wait`` holds
    ``(token, keys)`` pairs for keys reserved by other in-flight plans (each
    token resolves to the owner's ``(published_keys, vals)``); ``miss_keys``
    are reserved by *this* plan — after the backend round trip the owner must
    :meth:`~LabelStore.publish` (success) or :meth:`~LabelStore.cancel`
    (failure), or every waiter deadlocks."""

    seg_key: object
    hit_keys: np.ndarray
    hit_vals: np.ndarray
    miss_keys: np.ndarray
    wait: list
    token: Optional[Future]


class LabelStore:
    """Thread-safe shared label cache, bounded by ``max_bytes``, optionally
    persisted under ``root`` (module docstring has the full semantics)."""

    def __init__(self, max_bytes: int = 256 << 20, root: Optional[str] = None,
                 tracker=None):
        from ..obs import NULL_TRACKER

        self.max_bytes = int(max_bytes)
        self.root = root
        self.tracker = tracker if tracker is not None else NULL_TRACKER
        self._lock = threading.Lock()
        self._segments: "OrderedDict[object, _StoreSegment]" = OrderedDict()
        self._gen = 0
        self.hits = 0          # keys served from resident entries
        self.shared = 0        # keys served by riding another plan's call
        self.misses = 0        # keys reserved for backend execution
        self.insertions = 0
        self.evictions = 0     # whole segments dropped (LRU)
        self.trimmed = 0       # entries dropped from an over-budget segment
        self.saves = 0
        self.loads = 0
        if root is not None:
            self._load()

    # ---- the window-planner interface --------------------------------------

    def plan(self, seg_key, keys: np.ndarray) -> StorePlan:
        """Atomically classify sorted-unique ``keys`` into hit / wait / miss
        and reserve the misses (one token future for the whole miss set).
        Hit values are captured under the lock, so eviction between plan and
        commit can never fail a window."""
        keys = np.asarray(keys, np.int64)
        with self._lock:
            seg = self._segments.get(seg_key)
            if seg is None:
                seg = self._segments[seg_key] = _StoreSegment()
            self._segments.move_to_end(seg_key)
            hit, pos = seg.resident_mask(keys)
            hit_keys = keys[hit]
            hit_vals = seg.vals[pos[hit]]
            rest = keys[~hit]
            wait_map: "OrderedDict[Future, list]" = OrderedDict()
            if seg.pending:
                miss_list = []
                for k in rest.tolist():
                    fut = seg.pending.get(k)
                    if fut is None:
                        miss_list.append(k)
                    else:
                        wait_map.setdefault(fut, []).append(k)
                miss_keys = np.asarray(miss_list, np.int64)
            else:
                miss_keys = rest
            token = None
            if len(miss_keys):
                token = Future()
                for k in miss_keys.tolist():
                    seg.pending[k] = token
            self.hits += len(hit_keys)
            self.shared += len(rest) - len(miss_keys)
            self.misses += len(miss_keys)
            wait = [(fut, np.asarray(ks, np.int64))
                    for fut, ks in wait_map.items()]
        return StorePlan(seg_key=seg_key, hit_keys=hit_keys,
                         hit_vals=hit_vals, miss_keys=miss_keys,
                         wait=wait, token=token)

    def publish(self, plan: StorePlan, vals: np.ndarray) -> None:
        """Write back a successful backend round trip: insert the plan's miss
        keys, release their reservations, resolve the token (waiters — in
        this window or another service's — read ``(miss_keys, vals)`` from
        it), and enforce the memory budget."""
        if plan.token is None:
            return
        vals = np.asarray(vals, np.float64)
        with self._lock:
            seg = self._segments.get(plan.seg_key)
            if seg is not None:
                for k in plan.miss_keys.tolist():
                    if seg.pending.get(k) is plan.token:
                        del seg.pending[k]
                self._gen += 1
                self.insertions += seg.merge(plan.miss_keys, vals, self._gen)
                self._admit_locked(plan.seg_key)
        plan.token.set_result((plan.miss_keys, vals))

    def cancel(self, plan: StorePlan, exc: BaseException) -> None:
        """Release a failed plan's reservations and fail its token, so
        waiters fail retryably and the keys become reservable again."""
        if plan.token is None:
            return
        with self._lock:
            seg = self._segments.get(plan.seg_key)
            if seg is not None:
                for k in plan.miss_keys.tolist():
                    if seg.pending.get(k) is plan.token:
                        del seg.pending[k]
        if not plan.token.done():
            plan.token.set_exception(exc)

    def resident(self, seg_key, keys: np.ndarray) -> np.ndarray:
        """Boolean residency mask — observability/tests only: no counters,
        no reservations, no LRU touch."""
        keys = np.asarray(keys, np.int64)
        with self._lock:
            seg = self._segments.get(seg_key)
            if seg is None:
                return np.zeros(len(keys), bool)
            return seg.resident_mask(keys)[0]

    # ---- memory budget -----------------------------------------------------

    def _admit_locked(self, hot_key) -> None:
        total = sum(s.nbytes for s in self._segments.values())
        while total > self.max_bytes:
            victim = None
            for k, seg in self._segments.items():   # OrderedDict: LRU first
                if k == hot_key or seg.pending:
                    continue        # never the segment just touched, never
                    # one with in-flight reservations
                victim = k
                break
            if victim is not None:
                total -= self._segments.pop(victim).nbytes
                self.evictions += 1
                self.tracker.count("label_store.evictions")
                continue
            hot = self._segments.get(hot_key)
            if hot is None or len(hot.keys) <= 1:
                break
            self.trimmed += hot.trim_oldest_half()
            total = sum(s.nbytes for s in self._segments.values())

    # ---- persistence (repro_torch.checkpoint.label_io) ---------------------

    def save(self) -> int:
        """Persist every stable non-empty segment under ``root`` (atomic per
        segment); returns how many were written.  No-op without a root."""
        if self.root is None:
            return 0
        from ..checkpoint.label_io import save_segment

        with self._lock:
            snap = [
                (key, seg.keys.copy(), seg.vals.copy())
                for key, seg in self._segments.items()
                if len(seg.keys) and persistable_key(key)
            ]
        for key, keys, vals in snap:
            save_segment(self.root, key, keys, vals)
        with self._lock:
            self.saves += len(snap)
        return len(snap)

    def _load(self) -> None:
        from ..checkpoint.label_io import load_segments

        for key, keys, vals in load_segments(self.root):
            seg = _StoreSegment()
            seg.keys = np.asarray(keys, np.int64)
            seg.vals = np.asarray(vals, np.float64)
            seg.gens = np.zeros(len(seg.keys), np.int64)
            with self._lock:
                self._segments[key] = seg
                self.loads += 1
                self._admit_locked(key)

    # ---- observability -----------------------------------------------------

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return sum(s.nbytes for s in self._segments.values())

    def stats(self) -> dict:
        with self._lock:
            n_segments = len(self._segments)
            entries = sum(len(s.keys) for s in self._segments.values())
            nbytes = sum(s.nbytes for s in self._segments.values())
        served = self.hits + self.shared
        total = served + self.misses
        return {
            "store_segments": n_segments,
            "store_entries": entries,
            "store_bytes": nbytes,
            "store_hits": self.hits,
            "store_shared": self.shared,
            "store_misses": self.misses,
            "store_insertions": self.insertions,
            "store_evictions": self.evictions,
            "store_trimmed": self.trimmed,
            "store_saves": self.saves,
            "store_loads": self.loads,
            "store_hit_rate": round(served / total, 4) if total else 0.0,
        }

    def snapshot(self) -> dict[str, float]:
        """Unified stats surface: ``label_store.*`` namespaced floats."""
        return {
            "label_store." + k[len("store_"):]: float(v)
            for k, v in self.stats().items()
        }


__all__ = ["LabelStore", "StorePlan", "pack_tuples", "unpack_tuples",
           "persistable_key"]
