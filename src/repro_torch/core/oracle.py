"""Oracle interfaces, budget ledger, and the batched execution layer.

The Oracle is the expensive pairwise (k-tuple-wise) labeller (paper §2).
Every implementation routes through the ledger semantics implemented here,
which (a) enforce the user-facing guarantee "the Oracle will not be executed
on more than b tuples" and (b) cache results so pilot-stage labels are reused
in the main stage for free (paper §5.3: "to avoid applying Oracle on the same
data tuples twice, we cache the Oracle results").

Cache layout
------------
Results are cached under *flat* cross-product indices: a (n, k) tuple-index
array is encoded to a (n,) int64 key vector (``tuples_to_flat`` when the
per-table sizes are bound via :meth:`Oracle.bind_sizes`, a fixed bit-packing
otherwise) and looked up against a **sorted** key array with
``np.searchsorted`` — no Python dict, no per-tuple round trips.  The query
pipelines bind sizes from ``query.spec.sizes`` before labelling anything, so
keys are stable across all stages of a query.

Batch / flush lifecycle
-----------------------
Callers never issue per-call-site model batches; they accumulate requests and
flush once per pipeline stage::

    batch = OracleBatch(oracle)
    h1 = batch.submit(tuples_a)      # (n1, k) — nothing is labelled yet
    h2 = batch.submit(tuples_b)      # (n2, k)
    batch.flush()                    # one _label() over the deduped union
    h1.labels, h2.labels             # per-request results, original order

``flush()`` is atomic with respect to the ledger: it dedupes the pending keys
against each other *and* against the cache, charges the budget once for the
unique uncached tuples, and only then issues a single ``_label`` call and
merges the results.  If the charge would exceed the budget,
:class:`BudgetExceeded` is raised *before* any labelling or cache mutation —
a failed flush leaves the Oracle exactly as it was.  ``Oracle.label`` is
sugar for a one-request batch, so ad-hoc callers keep the old interface.

Async mode
----------
When an :class:`repro_torch.serve.oracle_service.OracleService` is attached
to the Oracle (``service.attach(oracle)``), ``flush_async()`` hands the
deduped pending set to the service and returns a
``concurrent.futures.Future``; the service micro-batches requests **across
queries**, executes them on its scorer-worker pool, and resolves the request
handles with exactly the semantics of a local flush (same dedup, same atomic
ledger charge, same retryability on failure).  Without a service,
``flush_async()`` degrades to an already-completed future around a local
flush, so pipeline stages can uniformly submit-then-await.  ``flush()``
stays the synchronous entry point and routes through the service when one
is attached — callers never need to know which mode they are in.

Counters: ``requests`` counts every tuple submitted (cache hits included),
``calls`` counts unique tuples actually labelled (what the budget meters),
``batches`` counts flushes that labelled at least one new tuple — a
well-batched query keeps ``batches`` at O(pipeline stages) regardless of the
number of strata.  For a local flush that is exactly the number of backend
``_label`` invocations; under an attached service, cross-query fusion and
worker sharding make the true backend-call count differ (see
``OracleService.stats()["backend_calls"]``).

Charge-once accounting (shared label store)
-------------------------------------------
When the attached service carries a :class:`repro_torch.serve.label_store
.LabelStore`, some of a flush's unique uncached keys are served from the
communal store instead of a backend execution.  Those keys still advance
``calls`` — the counter that paces the BAS pipeline and meters the
user-facing budget guarantee — so sampling decisions and estimates are
bit-identical to serial execution.  What changes is who *pays*: ``charged``
counts the keys this oracle's own flushes executed on a backend (the real
ledger spend), and ``store_hits``/``store_charge_saved`` count the keys
served communally.  Without a store ``charged == calls``; with one, the
workload-wide sum of ``charged`` equals the store's unique-miss count —
each distinct pair is charged exactly once, to its first requester.
"""
from __future__ import annotations

import abc
import dataclasses
import struct
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np


class BudgetExceeded(RuntimeError):
    pass


# Marker for service-group keys built from id(...) — equality works within
# the process (coalescing, store segments), but the key is meaningless in
# another process, so the shared label store never persists such segments.
PROCESS_LOCAL = "#process-local"


# ---- wire payloads ----------------------------------------------------------
#
# The multi-host transport (repro_torch.serve.transport) ships pre-planned
# label work between processes: a client plans a flush against its *own*
# cache and ledger, sends only the unique uncached tuple indices, and commits
# locally when the labels come back.  These two dataclasses are the payloads — pure
# numpy/struct encodings with a fixed little-endian layout, so the framing
# layer stays a dumb byte pipe and core/ carries the schema.  docs/serving.md
# documents the byte layout as part of the protocol spec.

_REQ_HDR = struct.Struct("<QIHH")   # request_id, n_rows, n_cols, group_len
_RES_HDR = struct.Struct("<QII")    # request_id, n_rows, error_len


@dataclasses.dataclass
class LabelRequest:
    """One pre-planned labelling segment: ``idx`` is the (n, k) int64 tuple
    indices to label through the server-side group ``group``.  The sender has
    already deduped against its cache and checked its budget — the server
    only executes."""

    group: str
    idx: np.ndarray
    request_id: int = 0

    def to_bytes(self) -> bytes:
        idx = np.ascontiguousarray(np.asarray(self.idx, dtype="<i8"))
        if idx.ndim != 2:
            raise ValueError(f"LabelRequest.idx must be (n, k), got {idx.shape}")
        group = self.group.encode("utf-8")
        hdr = _REQ_HDR.pack(self.request_id, idx.shape[0], idx.shape[1],
                            len(group))
        return hdr + group + idx.tobytes()

    @classmethod
    def from_bytes(cls, buf: bytes) -> "LabelRequest":
        request_id, n, k, glen = _REQ_HDR.unpack_from(buf, 0)
        off = _REQ_HDR.size
        group = buf[off:off + glen].decode("utf-8")
        off += glen
        want = n * k * 8
        raw = buf[off:off + want]
        if len(raw) != want:
            raise ValueError(
                f"LabelRequest payload truncated: {len(raw)} != {want} bytes"
            )
        idx = np.frombuffer(raw, dtype="<i8").reshape(n, k).astype(np.int64)
        return cls(group=group, idx=idx, request_id=request_id)


@dataclasses.dataclass
class LabelResult:
    """The server's reply to one :class:`LabelRequest`: either ``labels``
    (float64, aligned with the request's rows) or a non-empty ``error``
    string (``"ErrorType: message"``).  An errored result carries no rows."""

    request_id: int = 0
    labels: Optional[np.ndarray] = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error

    def to_bytes(self) -> bytes:
        err = self.error.encode("utf-8")
        if err:
            return _RES_HDR.pack(self.request_id, 0, len(err)) + err
        labels = np.ascontiguousarray(np.asarray(self.labels, dtype="<f8"))
        if labels.ndim != 1:
            raise ValueError(
                f"LabelResult.labels must be (n,), got {labels.shape}"
            )
        hdr = _RES_HDR.pack(self.request_id, len(labels), 0)
        return hdr + labels.tobytes()

    @classmethod
    def from_bytes(cls, buf: bytes) -> "LabelResult":
        request_id, n, elen = _RES_HDR.unpack_from(buf, 0)
        off = _RES_HDR.size
        if elen:
            return cls(request_id=request_id,
                       error=buf[off:off + elen].decode("utf-8"))
        raw = buf[off:off + n * 8]
        if len(raw) != n * 8:
            raise ValueError(
                f"LabelResult payload truncated: {len(raw)} != {n * 8} bytes"
            )
        labels = np.frombuffer(raw, dtype="<f8").astype(np.float64)
        return cls(request_id=request_id, labels=labels)


class Oracle(abc.ABC):
    """Labels k-tuples.  ``idx`` is an (n, k) int array of per-table indices."""

    def __init__(self):
        self._keys = np.empty(0, np.int64)    # sorted flat cache keys
        self._vals = np.empty(0, np.float64)  # labels aligned with _keys
        self._sizes: Optional[tuple] = None   # bound per-table sizes
        self._pack: Optional[tuple] = None    # fallback encoding (k, bit width)
        self.calls = 0          # unique tuples acquired (budget pacing)
        self.requests = 0       # total tuples requested (incl. cache hits)
        self.batches = 0        # backend _label invocations
        self.charged = 0        # unique tuples this oracle paid to execute
        self.store_hits = 0     # unique tuples served by a shared LabelStore
        self.store_charge_saved = 0   # ledger charges avoided via the store
        self.budget: Optional[int] = None
        self.service = None     # attached OracleService (None = local flushes)

    def set_budget(self, budget: Optional[int]) -> None:
        self.budget = budget

    # ---- key encoding ------------------------------------------------------

    def bind_sizes(self, sizes: Sequence[int]) -> None:
        """Bind the per-table sizes so cache keys are exact flat indices.

        Rebinding with different sizes re-keys any cached entries (decode with
        the old encoding, encode with the new), so a long-lived Oracle can
        serve queries over different join specs without losing its cache.
        """
        sizes = tuple(int(s) for s in sizes)
        if self._sizes == sizes:
            return
        if len(self._keys):
            # validate + re-encode under the old state, then commit atomically
            # (a failed rebind must not leave keys in a mixed encoding)
            idx = self._decode(self._keys)
            if idx.shape[1] != len(sizes):
                raise ValueError(
                    f"bind_sizes: cache holds {idx.shape[1]}-tuples, "
                    f"got {len(sizes)} sizes"
                )
            if any(idx[:, j].max(initial=0) >= sizes[j] for j in range(idx.shape[1])):
                raise ValueError("bind_sizes: cached tuples exceed new sizes")
            keys = np.ravel_multi_index(
                tuple(idx[:, j] for j in range(idx.shape[1])), sizes
            ).astype(np.int64)
            order = np.argsort(keys, kind="stable")
            self._keys, self._vals = keys[order], self._vals[order]
        self._sizes, self._pack = sizes, None

    def _encode(self, idx: np.ndarray) -> np.ndarray:
        """(n, k) tuple indices -> (n,) int64 flat keys."""
        k = idx.shape[1]
        if self._sizes is not None:
            if len(self._sizes) != k:
                raise ValueError(
                    f"oracle bound to {len(self._sizes)} tables, got {k}-tuples"
                )
            return np.ravel_multi_index(
                tuple(idx[:, j] for j in range(k)), self._sizes
            ).astype(np.int64)
        # unbound fallback: fixed-width bit packing (stable across requests)
        if self._pack is None:
            self._pack = (k, 63 // k)
        elif self._pack[0] != k:
            raise ValueError(
                f"oracle cache packs {self._pack[0]}-tuples, got {k}-tuples"
            )
        _, bits = self._pack
        if idx.size and int(idx.max()) >= (1 << bits):
            raise ValueError(
                f"tuple index {int(idx.max())} does not fit the unbound "
                f"{bits}-bit key packing for k={k}; call oracle.bind_sizes()"
            )
        keys = np.zeros(idx.shape[0], np.int64)
        for j in range(k):
            keys = (keys << bits) | idx[:, j].astype(np.int64)
        return keys

    def _decode(self, keys: np.ndarray) -> np.ndarray:
        """(n,) flat keys -> (n, k) tuple indices (inverse of _encode)."""
        if self._sizes is not None:
            return np.stack(
                np.unravel_index(keys, self._sizes), axis=1
            ).astype(np.int64)
        k, bits = self._pack
        mask = (1 << bits) - 1
        cols = [(keys >> (bits * (k - 1 - j))) & mask for j in range(k)]
        return np.stack(cols, axis=1).astype(np.int64)

    # ---- labelling ---------------------------------------------------------

    @abc.abstractmethod
    def _label(self, idx: np.ndarray) -> np.ndarray:
        """Raw labelling; returns float array in {0.0, 1.0} of shape (n,)."""

    def label(self, idx: np.ndarray) -> np.ndarray:
        """One-request batch: submit + flush + return labels."""
        batch = OracleBatch(self)
        handle = batch.submit(idx)
        batch.flush()
        return handle.labels

    def service_group(self):
        """Coalescing key: flushes from oracles with *equal* keys may be fused
        into one backend execution by an attached service.  Two oracles share
        a key only when ``_label`` is the same pure function of the tuple
        indices for both (same backend model, same table bindings).  The
        default is per-instance (no cross-oracle fusion, but requests still
        micro-batch into the same service window and shard over its worker
        pool); :class:`ModelOracle` keys on its shared scorer.  id()-based
        keys carry the :data:`PROCESS_LOCAL` marker so the shared label
        store knows they cannot be persisted across restarts."""
        return (PROCESS_LOCAL, "oracle", id(self))

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Cached labels for already-resolved keys (keys must all be cached)."""
        pos = np.searchsorted(self._keys, keys)
        return self._vals[pos]

    def _cached_mask(self, keys: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._keys, keys)
        in_range = pos < len(self._keys)
        hit = np.zeros(len(keys), bool)
        hit[in_range] = self._keys[pos[in_range]] == keys[in_range]
        return hit

    def _merge(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Insert new (key, label) pairs, keeping the cache sorted."""
        merged_k = np.concatenate([self._keys, keys])
        merged_v = np.concatenate([self._vals, vals])
        order = np.argsort(merged_k, kind="stable")
        self._keys, self._vals = merged_k[order], merged_v[order]

    @property
    def remaining(self) -> Optional[int]:
        return None if self.budget is None else self.budget - self.calls

    @property
    def dedup_ratio(self) -> float:
        """Fraction of requested labels served without a backend execution."""
        if self.requests == 0:
            return 0.0
        return 1.0 - self.calls / self.requests

    def stats(self) -> dict:
        return {
            "calls": self.calls,
            "requests": self.requests,
            "batches": self.batches,
            "charged": self.charged,
            "store_hits": self.store_hits,
            "store_charge_saved": self.store_charge_saved,
            "dedup_ratio": round(self.dedup_ratio, 4),
        }

    def reset(self) -> None:
        self._keys = np.empty(0, np.int64)
        self._vals = np.empty(0, np.float64)
        self.calls = 0
        self.requests = 0
        self.batches = 0
        self.charged = 0
        self.store_hits = 0
        self.store_charge_saved = 0


def plan_requests(
    oracle: Oracle,
    requests: Sequence["OracleRequest"],
    extra_planned: Optional[np.ndarray] = None,
) -> tuple:
    """Plan a flush without mutating anything: encode every request, dedupe
    against the cache (and against ``extra_planned`` — keys another flush in
    the same service window has already claimed for this oracle), and check
    the budget.  Returns ``(keys_list, n_requested, new_keys)``; raises
    :class:`BudgetExceeded` if labelling ``new_keys`` would overrun.

    This is THE flush-planning algorithm: ``OracleBatch._flush_local`` and
    ``OracleService`` both call it, so local and served execution cannot
    drift apart semantically."""
    keys_list = [oracle._encode(r.idx) for r in requests]
    all_keys = (np.concatenate(keys_list) if keys_list
                else np.empty(0, np.int64))
    hit = oracle._cached_mask(all_keys)
    new_keys = np.unique(all_keys[~hit])
    already = 0
    if extra_planned is not None and len(extra_planned):
        new_keys = np.setdiff1d(new_keys, extra_planned, assume_unique=False)
        already = len(extra_planned)
    if len(new_keys) and oracle.budget is not None and (
            oracle.calls + already + len(new_keys) > oracle.budget):
        used = f"{oracle.calls} used"
        if already:
            used += f" (+{already} planned this window)"
        raise BudgetExceeded(
            f"oracle budget {oracle.budget} exceeded: {used}, "
            f"{len(new_keys)} new requested"
        )
    return keys_list, len(all_keys), new_keys


def commit_requests(
    oracle: Oracle,
    requests: Sequence["OracleRequest"],
    keys_list: list,
    n_requested: int,
    new_keys: np.ndarray,
    new_vals: Optional[np.ndarray],
    store_keys: Optional[np.ndarray] = None,
    store_vals: Optional[np.ndarray] = None,
) -> None:
    """Commit an executed flush: merge the fresh labels into the cache,
    charge the ledger atomically, and resolve every request handle.  The
    counterpart of :func:`plan_requests`, shared by local and served flushes;
    callers invoke it only after the backend execution succeeded.

    ``store_keys``/``store_vals`` are the store-consultation phase's output:
    keys of this flush served from a shared :class:`repro_torch.serve
    .label_store.LabelStore` instead of a backend execution.  They merge into
    the cache and advance ``calls`` exactly like executed keys (so budget
    pacing — and therefore every estimate — is bit-identical to serial
    execution), but the ledger charge lands on ``store_hits``/
    ``store_charge_saved`` rather than ``charged``: the store's first
    requester already paid."""
    n_store = len(store_keys) if store_keys is not None else 0
    if len(new_keys):
        oracle._merge(new_keys, new_vals)
        oracle.charged += len(new_keys)
        oracle.batches += 1
    if n_store:
        oracle._merge(store_keys, store_vals)
        oracle.store_hits += n_store
        oracle.store_charge_saved += n_store
    oracle.calls += len(new_keys) + n_store
    oracle.requests += n_requested
    for r, keys in zip(requests, keys_list):
        r._labels = oracle.lookup(keys)


class OracleRequest:
    """Handle returned by :meth:`OracleBatch.submit`; ``labels`` is populated
    by the owning batch's ``flush()``."""

    __slots__ = ("idx", "_labels")

    def __init__(self, idx: np.ndarray):
        self.idx = idx
        self._labels: Optional[np.ndarray] = None

    @property
    def labels(self) -> np.ndarray:
        if self._labels is None:
            raise RuntimeError("OracleBatch not flushed yet")
        return self._labels


class OracleBatch:
    """Request accumulator: coalesces many call sites into one ledger charge
    and one backend batch (see module docstring for the lifecycle)."""

    def __init__(self, oracle: Oracle):
        self.oracle = oracle
        self._pending: list[OracleRequest] = []

    def submit(self, idx: np.ndarray) -> OracleRequest:
        idx = np.asarray(idx)
        if idx.ndim == 1:
            idx = idx[:, None]
        req = OracleRequest(idx)
        self._pending.append(req)
        return req

    def flush(self) -> None:
        """Dedupe all pending requests, charge the ledger once, label once.

        Atomic: if the flush fails — :class:`BudgetExceeded` or a backend
        error from ``_label`` — nothing is mutated (no cache entries, no
        counters) and the requests stay pending, so the same batch can be
        retried after raising the budget or recovering the backend.  Keys
        are encoded at flush time, so a ``bind_sizes`` rebind between submit
        and flush is safe.

        An **empty** pending set is a guaranteed no-op: no backend call, no
        budget charge (even when the budget is already exhausted), and no
        counter movement.  With a service attached, routes through
        :meth:`flush_async` so concurrent queries coalesce."""
        self.flush_async().result()

    def flush_async(self) -> Future:
        """Submit-then-await entry point: returns a future that resolves
        (to ``None``) once every pending request's ``labels`` is populated.

        With a service attached to the oracle, the deduped pending set is
        enqueued into the service's micro-batching window and labelled on its
        worker pool alongside other queries' flushes; otherwise the flush
        runs locally (synchronously) and the returned future is already
        done.  Failures (:class:`BudgetExceeded`, backend errors) surface at
        ``.result()``; the requests stay pending in either mode, so the same
        batch can be retried."""
        if self.oracle.service is not None and self._pending:
            return self.oracle.service.submit(self)
        fut: Future = Future()
        try:
            self._flush_local()
        except BaseException as e:  # surfaced at .result(), like the service
            fut.set_exception(e)
        else:
            fut.set_result(None)
        return fut

    def _flush_local(self) -> None:
        """The synchronous flush: plan against the cache, execute, commit.
        Any failure before the commit leaves the oracle and the pending set
        exactly as they were."""
        if not self._pending:
            return
        o = self.oracle
        keys_list, n_requested, new_keys = plan_requests(o, self._pending)
        new_vals = None
        if len(new_keys):
            new_vals = np.asarray(o._label(o._decode(new_keys)), np.float64)
        pending, self._pending = self._pending, []
        commit_requests(o, pending, keys_list, n_requested, new_keys, new_vals)


class ArrayOracle(Oracle):
    """Ground-truth labels from a dense k-dim {0,1} array (tests/benchmarks)."""

    def __init__(self, truth: np.ndarray):
        super().__init__()
        self.truth = np.asarray(truth)
        self.bind_sizes(self.truth.shape)

    def _label(self, idx: np.ndarray) -> np.ndarray:
        return self.truth[tuple(idx[:, j] for j in range(idx.shape[1]))].astype(
            np.float64
        )


class FnOracle(Oracle):
    """Labels via an arbitrary vectorised callable (e.g. pairwise chain rule)."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        super().__init__()
        self.fn = fn

    def _label(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(self.fn(idx), dtype=np.float64)


class PairChainOracle(Oracle):
    """k-way chain-join Oracle from per-edge pair label matrices.

    A k-tuple matches iff every consecutive pair matches — the semantics the
    paper uses for its multi-way joins (Company-Scale, Ecomm-Q10/Q11).
    """

    def __init__(self, edge_truth: list[np.ndarray]):
        super().__init__()
        self.edge_truth = [np.asarray(m) for m in edge_truth]
        self.bind_sizes(
            tuple(m.shape[0] for m in self.edge_truth)
            + (self.edge_truth[-1].shape[1],)
        )

    def _label(self, idx: np.ndarray) -> np.ndarray:
        out = np.ones(idx.shape[0], dtype=np.float64)
        for e, m in enumerate(self.edge_truth):
            out *= m[idx[:, e], idx[:, e + 1]].astype(np.float64)
        return out


class ModelOracle(Oracle):
    """Oracle backed by a served model: scorer(idx) -> probability, thresholded.

    ``scorer`` is the serving stack's batched pair scorer — either a
    :class:`repro_torch.serve.PairScorer` instance or any vectorised
    callable; this class only adds the ledger semantics.  Because callers
    route through :class:`OracleBatch`, the scorer receives each pipeline
    stage's deduped union as one large request and applies its own device
    batching internally.

    ``name`` optionally gives the scorer a *stable* identity: named oracles
    fuse (and share label-store segments) by name rather than by object id,
    so their segments survive a service restart when the store persists to
    disk.  Naming is a contract — every oracle sharing a name must score
    through the same model weights.
    """

    def __init__(self, scorer, threshold: float = 0.5,
                 name: Optional[str] = None):
        super().__init__()
        self.scorer = scorer.score if hasattr(scorer, "score") else scorer
        self.threshold = threshold
        self.name = name

    def _label(self, idx: np.ndarray) -> np.ndarray:
        probs = np.asarray(self.scorer(idx), dtype=np.float64)
        return (probs >= self.threshold).astype(np.float64)

    def service_group(self):
        """Fuse with every oracle scoring through the same served model at the
        same threshold: concurrent queries against one scorer become one
        super-batch per service window.  Named oracles key on the name (a
        stable, persistable identity); unnamed ones key on the scorer
        *object* — for a bound ``scorer.score`` the owning instance, via
        ``__self__``, since each attribute access creates a fresh
        bound-method object whose id would never match across oracles."""
        if self.name is not None:
            return ("scorer", str(self.name), float(self.threshold))
        backend = getattr(self.scorer, "__self__", self.scorer)
        return (PROCESS_LOCAL, "scorer", id(backend), float(self.threshold))
