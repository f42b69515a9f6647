"""Async oracle serving substrate: cross-query coalescing between
``OracleBatch.flush()`` and the scorer-worker pool.

Why
---
The paper's cost model makes the ML Oracle the dominant expense, so the
serving layer must keep the scorer saturated. The batched execution layer
(``repro_torch.core.oracle``) already coalesces each *query's* labelling
into a handful of flushes — but concurrent queries still serialize on one
scorer, and every flush blocks its query until the backend returns. This
module turns the oracle layer from a per-query library into a shared serving
subsystem: one :class:`OracleService` feeds any number of concurrent
queries.

Architecture
------------
::

    query 1 ── OracleBatch.flush_async() ──┐          (request queue)
    query 2 ── OracleBatch.flush_async() ──┼──►  ┌────────────────────┐
      ...                                  │     │  dispatcher thread  │
    query N ── OracleBatch.flush_async() ──┘     │  window assembly:   │
                                                 │  size- & deadline-  │
                 future.result() ◄── per-client  │  triggered flush    │
                 (labels resolved,   routing     └─────────┬──────────┘
                  ledger charged                           │ super-batch
                  atomically)                              ▼ (grouped by
                                                 ┌────────────────────┐
                                                 │  scorer worker pool │
                                                 │  shard 0 … shard W  │
                                                 │  (threads, and      │
                                                 │  worker hosts over  │
                                                 │  the transport)     │
                                                 └────────────────────┘

* **Clients** are ordinary :class:`~repro_torch.core.oracle.OracleBatch`
  objects.  ``service.attach(oracle)`` routes that oracle's flushes here;
  ``flush_async()`` enqueues the pending request set and returns a future.
  Each query keeps its own Oracle (cache + budget ledger) — the service
  never mixes ledgers.
* The **dispatcher** assembles micro-batch *windows*: a window opens when the
  first flush arrives and closes when (a) the accumulated rows reach
  ``max_batch``, (b) ``max_wait_ms`` elapses, or (c) every attached client
  already has a flush in the window (nobody left to wait for).  A single
  attached client dispatches immediately — solo queries pay no windowing
  latency.
* Each window's segments are **planned sequentially in arrival order** with
  exactly the local-flush semantics: encode at flush time, dedup against the
  client's cache (and against earlier same-oracle segments in the window),
  check the budget.  Planning failures (:class:`BudgetExceeded`, encode
  errors) complete only that client's future; its requests return to the
  batch so the flush can be retried — one query's exhaustion never poisons
  another's batch.
* Planned rows are grouped by :meth:`Oracle.service_group` — oracles scoring
  through the same served model fuse into one **super-batch** per window —
  and each group is sharded over the worker pool.  Workers are threads (the
  backends release the GIL in numpy and torch); each worker executes shards
  via the group's own ``_label`` — a
  :class:`~repro_torch.serve.serve_loop.PairScorer` backend runs each
  shard's batches on its card.  A backend error fails exactly the
  segments of that group (retryable), leaving other groups' results intact.
* **Commit** happens after execution, per segment in arrival order: merge the
  new labels into the client's cache, charge its ledger atomically, resolve
  the request handles, complete the future.
* With a **shared label store** attached (``label_store=``, see
  ``repro_torch.serve.label_store``), a store-consultation phase sits between
  plan and execute: keys surviving the per-client dedup are split into resident
  hits, in-flight waits, and true misses *before any ledger is charged* —
  only misses execute, successful results are written back communally, and
  hits/waits are served at commit time under a charge-once budget policy
  (first requester pays; everyone else's ``calls`` still advances exactly
  as in serial execution, so estimates stay bit-identical).

* **Observability + admission control** (``repro_torch.obs``): a pluggable
  :class:`~repro_torch.obs.Tracker` receives window assembly latency,
  fill/dedup ratios, per-host shard latency, and per-query-class end-to-end
  flush latency; everything is summarised through one namespaced
  :meth:`OracleService.snapshot` surface.  Clients attached with a
  ``deadline_ms`` class are subject to deadline-based admission control:
  when the measured service rate times the queued backlog implies a
  deadline miss, their flushes are rejected *before anything is dequeued or
  charged* with a retryable :class:`AdmissionRejected`.  Worker hosts are
  health-checked in the background — a failing host is unregistered (its
  shards fall back to local execution) and automatically
  re-registered when its ping answers again.  Each flush's wait from its
  enqueue to its window's dispatch is its query's span ``joinml.queue_wait``
  (and the tracker's ``service.window.assembly_ms``); each window is a span
  ``joinml.service.window`` of every query whose rows it holds.

The window/plan/commit machinery here is transport-agnostic, and
``repro_torch.serve.transport`` puts a network in front of it: remote client
processes submit pre-planned segments via :meth:`OracleService.submit_raw`
(they plan and commit against their own cache/ledger, so the service only
executes), window assembly counts connected transport clients exactly like
attached in-process oracles, and :meth:`OracleService.register_remote_worker`
extends the worker pool across hosts — super-batches for named wire groups
shard over worker hosts as well as local threads/devices.  The architecture
narrative, wire protocol spec, and deployment topology live in
docs/serving.md.
"""
from __future__ import annotations

import contextvars
import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..core.oracle import (
    Oracle,
    OracleBatch,
    commit_requests,
    plan_requests,
)
from ..obs import (
    NULL_TRACKER,
    NoopTracker,
    StreamingHistogram,
    merge_snapshots,
    telemetry,
)
from .transport import ThroughputEWMA


class AdmissionRejected(RuntimeError):
    """A flush shed by deadline-based admission control.

    Raised by :meth:`OracleService.submit` *before* anything is dequeued,
    planned, or charged — the batch's pending set is untouched and the
    ledger never moves, so the caller may simply retry the flush (back off,
    or re-submit once the queue drains).  ``retryable`` mirrors the
    transport layer's error taxonomy."""

    retryable = True

    def __init__(self, qclass: str, deadline_ms: float, predicted_ms: float,
                 queue_rows: int):
        super().__init__(
            f"admission rejected: class {qclass!r} declared a "
            f"{deadline_ms:.0f}ms deadline but the predicted window wait is "
            f"{predicted_ms:.0f}ms ({queue_rows} rows queued)"
        )
        self.qclass = qclass
        self.deadline_ms = deadline_ms
        self.predicted_ms = predicted_ms
        self.queue_rows = queue_rows


@dataclasses.dataclass
class _Segment:
    """One enqueued flush: a client batch's pending set plus its future.

    Two flavours share the queue: **oracle segments** (an in-process
    ``OracleBatch`` flush — plan against the client's cache, commit to its
    ledger) and **raw segments** (pre-planned work from a transport client
    via :meth:`OracleService.submit_raw` — the remote client already planned
    against its own cache, so the service only executes and the future
    resolves to the label array)."""

    batch: Optional[OracleBatch]
    oracle: Optional[Oracle]
    requests: list
    future: Future
    rows: int
    # raw-segment fields (transport path)
    raw: bool = False
    key: object = None          # service-group key; raw: ("wire", name)
    fn: Optional[Callable] = None
    idx: Optional[np.ndarray] = None
    client_id: Optional[int] = None
    # observability: enqueue time (``perf_counter_ns``; the queue_wait span
    # starts there) + deadline class, and the submitter's query and open span
    t_enqueue: int = 0
    qclass: str = "default"
    query: Optional[telemetry.ActiveQuery] = None
    span_id: Optional[int] = None

    def group_key(self):
        return self.key if self.raw else self.oracle.service_group()

    def label_fn(self) -> Callable:
        return self.fn if self.raw else self.oracle._label

    def fail(self, exc: BaseException) -> None:
        """Complete exceptionally; for oracle segments additionally hand the
        requests back to the batch so the same flush can be retried (mirrors
        local-flush atomicity).  Raw segments hold no client state — the
        remote client's own batch keeps its pending set."""
        if not self.raw:
            self.batch._pending = self.requests + self.batch._pending
        self.future.set_exception(exc)


@dataclasses.dataclass
class _Plan:
    """A successfully planned segment, ready for group execution.

    With a shared label store attached, ``new_keys``/``new_idx`` hold only
    the store *misses* (the rows actually executed); ``store`` carries the
    consultation result — resident hits (values captured at plan time, so
    eviction can't fail the window), in-flight waits, and this plan's
    reservation token, which execution must publish or cancel."""

    seg: _Segment
    keys_list: list            # per-request encoded keys
    n_requested: int           # total rows incl. cache hits
    new_keys: np.ndarray       # unique uncached keys this segment labels
    new_idx: np.ndarray        # decoded (n_new, k) tuple indices
    vals: Optional[np.ndarray] = None   # labels for new_keys (set by execute)
    store: Optional[object] = None      # label_store.StorePlan (None: none)
    row_keys: Optional[np.ndarray] = None   # raw segments: per-row flat keys


def _encoding_key(oracle: Oracle):
    """The key-encoding half of a label-store segment key: two oracles may
    share stored labels only when their int64 flat keys mean the same tuples
    (same bound sizes, or the same unbound bit packing)."""
    if oracle._sizes is not None:
        return ("sizes",) + tuple(oracle._sizes)
    if oracle._pack is not None:
        return ("pack",) + tuple(oracle._pack)
    return None


class OracleService:
    """Micro-batching request broker between OracleBatch clients and a pool
    of scorer workers (module docstring has the full architecture).

    Parameters
    ----------
    workers:
        Worker threads sharding each super-batch.  Shards run the group's
        vectorised ``_label`` concurrently; backends must be pure per row
        (true for every Oracle here — labels are per-tuple).
    max_batch:
        Row-count window trigger: a window dispatches as soon as its
        accumulated request rows reach this.
    max_wait_ms:
        Deadline window trigger: maximum time the dispatcher waits after the
        first flush of a window for more clients to arrive.
    min_shard:
        Smallest shard worth its own worker; groups below ``2 * min_shard``
        rows execute unsharded (sharding a padded scorer batch too finely
        wastes pad rows).
    index_store:
        Optional :class:`repro_torch.core.index.IndexStore` shared by the
        queries served here: concurrent queries on the same table pair stratify from
        one resident artifact instead of each paying the sweep (route it via
        ``dispatch.run_auto(index_store=service.index_store)`` or
        ``JoinMLEngine(index_store=...)``).  The service owns no routing —
        it just gives the store a service-scoped home and merges its
        counters into :meth:`stats`.
    label_store:
        Optional :class:`repro_torch.serve.label_store.LabelStore`: the window
        planner then dedupes each plan's uncached keys against the communal
        store *before any ledger is charged* — resident hits and keys
        reserved by another in-flight plan are served at commit time, only
        true misses execute (and are written back on success).  Off by
        default: without a store, served execution charges exactly like a
        local flush.  Raw (transport) segments get the same treatment
        whenever their tuple indices fit the store's bit packing, so remote
        clients' EXEC answers can be store-served too.  ``close()`` calls
        ``label_store.save()``.
    tracker:
        Optional :class:`repro_torch.obs.Tracker` receiving the service's
        signals (window assembly latency, fill/dedup ratios, per-host shard latency,
        per-class flush latency, admission/worker events).  Defaults to the
        noop tracker — the uninstrumented fast path.  Attached stores that
        have no tracker of their own inherit this one.
    health_check_s:
        Period of the background worker-host health checker (started with
        the first :meth:`register_remote_worker`).  A host that fails a
        shard or a ping is unregistered — its groups fall back to local
        execution — and automatically re-registered (groups re-fetched)
        once its ping answers again.  ``0`` disables the checker: a failed
        host then stays unregistered (fail-to-local only).
    """

    def __init__(self, workers: int = 1, max_batch: int = 8192,
                 max_wait_ms: float = 4.0, min_shard: int = 256,
                 index_store=None, label_store=None, tracker=None,
                 health_check_s: float = 2.0):
        self.index_store = index_store
        self.label_store = label_store
        self.tracker = tracker if tracker is not None else NULL_TRACKER
        # one flag gate for the hot-path hooks: a NoopTracker pays nothing
        self._tracking = not isinstance(self.tracker, NoopTracker)
        for store in (index_store, label_store):
            if store is not None and isinstance(
                getattr(store, "tracker", None), NoopTracker
            ):
                store.tracker = self.tracker
        self.workers = max(int(workers), 1)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.min_shard = max(int(min_shard), 1)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: list[_Segment] = []
        # weak: an attached oracle that is dropped without detach must not
        # stall window assembly (or alias a recycled address) forever
        self._clients: "weakref.WeakSet[Oracle]" = weakref.WeakSet()
        # transport clients (repro_torch.serve.transport): counted, not
        # attached — the server tells us how many connections could still contribute to
        # the open window (window assembly's remote analogue of _clients)
        self._remote_clients: set[int] = set()
        self._client_seq = 0
        # worker hosts (RemoteWorkerClient-shaped: .groups + .execute);
        # super-batches for wire groups they advertise shard across them
        self._remote_workers: list = []
        # hosts that failed a shard or a ping: skipped by _eligible_workers
        # until the health checker sees their ping answer again
        self._dead_workers: list = []
        self.health_check_s = float(health_check_s)
        self._health_thread: Optional[threading.Thread] = None
        self._health_stop = threading.Event()
        # deadline-based admission control: per-oracle deadline class
        # (attach(deadline_ms=...)), an EWMA of the measured service rate in
        # rows/s, and the backlog the next flush would queue behind
        self._deadlines: "weakref.WeakKeyDictionary[Oracle, float]" = (
            weakref.WeakKeyDictionary()
        )
        self._classes: "weakref.WeakKeyDictionary[Oracle, str]" = (
            weakref.WeakKeyDictionary()
        )
        self._service_rate = 0.0    # rows/s EWMA; 0 = not yet measured
        # per-deadline-class EWMAs: each window's rate sample updates every
        # class present in that window, so one slow class's measurements
        # never drag down the predicted wait of a fast class (global-rate
        # sharing let a slow tenant shed a fast tenant's queries)
        self._class_rates: dict[str, float] = {}
        self._queued_rows = 0
        self._inflight_rows = 0
        self._closed = False
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=self.workers,
                               thread_name_prefix="oracle-worker")
            if self.workers > 1 else None
        )
        self._retired_pools: list[ThreadPoolExecutor] = []
        # observability (read via stats(); written by the dispatcher, except
        # remote_shards/remote_failures — worker-pool threads update those
        # under _stats_lock)
        self._stats_lock = threading.Lock()
        self.windows = 0
        self.segments = 0
        self.backend_calls = 0
        self.rows_requested = 0
        self.rows_labelled = 0
        self.window_rows = 0        # rows entering windows (fill ratio)
        self.rows_planned = 0       # rows surviving per-client cache dedup
        self.remote_shards = 0
        self.remote_failures = 0
        # per-executor rows/s EWMAs ("local" + one per worker host label):
        # _execute sizes shards in proportion to these (capacity-weighted
        # splits).  Keyed creation is guarded by
        # _stats_lock; each EWMA is itself thread-safe.
        self._shard_rates: dict[str, ThroughputEWMA] = {}
        self.admission_rejections = 0
        self.worker_deaths = 0
        self.worker_rejoins = 0
        # last-N per-window fill/dedup ratios: the lifetime ratios in stats()
        # average warmup in forever; these power the *_recent snapshot keys
        # (written by the dispatcher only, read lock-free by snapshot())
        self._fill_hist = StreamingHistogram(window=256)
        self._dedup_hist = StreamingHistogram(window=256)
        self._dispatcher = threading.Thread(
            target=self._run, name="oracle-service", daemon=True
        )
        self._dispatcher.start()

    # ---- client lifecycle --------------------------------------------------

    def attach(self, *oracles: Oracle, deadline_ms: Optional[float] = None,
               query_class: Optional[str] = None) -> "OracleService":
        """Route the oracles' flushes through this service.  The attached set
        also drives window assembly: a window closes early once every
        attached client has a flush in it.

        ``deadline_ms`` declares a deadline class: flushes from these oracles
        are shed with :class:`AdmissionRejected` whenever the measured
        service rate and queued backlog predict a wait beyond the deadline.
        Clients without a deadline are never shed.  ``query_class`` names the
        class for per-class latency telemetry (defaults to ``dl<deadline>``,
        or ``"default"`` with no deadline)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("OracleService is closed")
            for o in oracles:
                o.service = self
                self._clients.add(o)
                if deadline_ms is not None:
                    self._deadlines[o] = float(deadline_ms)
                    self._classes[o] = query_class or f"dl{int(deadline_ms)}"
                elif query_class is not None:
                    self._classes[o] = query_class
        return self

    def detach(self, *oracles: Oracle) -> None:
        """Return the oracles to local (synchronous) flushing.  Detaching
        finished queries keeps windows from waiting on clients that will
        never flush again."""
        with self._cv:
            for o in oracles:
                if o.service is self:
                    o.service = None
                self._clients.discard(o)
                self._deadlines.pop(o, None)
                self._classes.pop(o, None)
            self._cv.notify_all()

    def _predicted_wait_ms_locked(self, rows: int,
                                  qclass: str = "default") -> float:
        """Expected queue wait for a flush of ``rows`` rows, from the
        class's own EWMA service rate and the backlog (queued + in-flight +
        this flush) it would land behind, plus the window-assembly deadline.
        0 until the class has a measured window (admit during warmup) —
        falling back to another class's rate would reintroduce exactly the
        cross-tenant coupling the per-class budgets exist to remove."""
        rate = self._class_rates.get(qclass, 0.0)
        if rate <= 0.0:
            return 0.0
        backlog = self._queued_rows + self._inflight_rows + rows
        return 1e3 * backlog / rate + 1e3 * self.max_wait_s

    def submit(self, batch: OracleBatch) -> Future:
        """Enqueue a batch's pending set; called by ``flush_async``.  The
        caller must not touch the batch again until the future resolves
        (one outstanding flush per batch — the submit-then-await protocol
        every pipeline stage follows).

        If the batch's oracle declared a deadline class (``attach`` with
        ``deadline_ms``) and the predicted wait exceeds it, raises
        :class:`AdmissionRejected` *without dequeuing anything* — the
        pending set and the ledger are untouched, so the flush can simply
        be retried."""
        rows = sum(len(r.idx) for r in batch._pending)
        deadline_ms = self._deadlines.get(batch.oracle)
        qclass = self._classes.get(batch.oracle, "default")
        with self._cv:
            if self._closed:
                raise RuntimeError("OracleService is closed")
            if deadline_ms is not None:
                predicted = self._predicted_wait_ms_locked(rows, qclass)
                if predicted > deadline_ms:
                    self.admission_rejections += 1
                    queued = self._queued_rows + self._inflight_rows
                    self.tracker.count("service.admission.rejected")
                    self.tracker.event(
                        "service.admission.rejected", qclass=qclass,
                        deadline_ms=deadline_ms, predicted_ms=predicted,
                    )
                    raise AdmissionRejected(qclass, deadline_ms, predicted,
                                            queued)
            requests, batch._pending = batch._pending, []
            query, parent = telemetry.current()
            seg = _Segment(
                batch=batch, oracle=batch.oracle, requests=requests,
                future=Future(), rows=rows,
                t_enqueue=time.perf_counter_ns(), qclass=qclass,
                query=query, span_id=parent,
            )
            self._queue.append(seg)
            self._queued_rows += rows
            self._cv.notify_all()
        if self._tracking:
            self._track_flush(seg)
        return seg.future

    def _track_flush(self, seg: _Segment) -> None:
        """Observe the segment's end-to-end latency under its deadline class
        when its future completes (success or failure)."""
        name = f"service.class.{seg.qclass}.flush_ms"

        def done(_fut) -> None:
            self.tracker.observe(
                name, (time.perf_counter_ns() - seg.t_enqueue) / 1e6
            )

        seg.future.add_done_callback(done)

    # ---- transport integration (repro_torch.serve.transport) ---------------

    def client_connected(self) -> int:
        """Register one announced transport connection for window assembly;
        returns its client id.  Windows wait (up to the deadline) for every
        registered transport client that is not yet present, exactly like
        attached in-process oracles.  The transport server calls this only
        for connections that declared themselves query clients (HELLO or a
        first EXEC), never for control-plane or silent connections.  The
        condition is notified, so a caller can wait for a set of clients to
        be registered instead of sleeping."""
        with self._cv:
            self._client_seq += 1
            cid = self._client_seq
            self._remote_clients.add(cid)
            self._cv.notify_all()
            return cid

    def client_disconnected(self, client_id: int) -> None:
        """Forget a transport connection so windows stop waiting for it."""
        with self._cv:
            self._remote_clients.discard(client_id)
            self._cv.notify_all()

    def submit_raw(self, name: str, fn: Callable, idx: np.ndarray,
                   client_id: Optional[int] = None) -> Future:
        """Enqueue pre-planned label work: ``idx`` rows to execute through
        ``fn`` under wire group ``name``.  The returned future resolves to
        the (n,) float64 label array.  Used by the transport server — the
        remote client already planned (dedup + budget) against its own
        oracle, so these segments skip planning and commit and still get
        window coalescing, super-batch fusion, and worker sharding."""
        idx = np.asarray(idx)
        seg = _Segment(
            batch=None, oracle=None, requests=[], future=Future(),
            rows=int(len(idx)), raw=True, key=("wire", str(name)), fn=fn,
            idx=idx, client_id=client_id,
            t_enqueue=time.perf_counter_ns(), qclass="remote",
        )
        with self._cv:
            if self._closed:
                raise RuntimeError("OracleService is closed")
            self._queue.append(seg)
            self._queued_rows += seg.rows
            self._cv.notify_all()
        if self._tracking:
            self._track_flush(seg)
        return seg.future

    def register_remote_worker(self, worker) -> None:
        """Add a worker host to the execution pool.  ``worker`` needs
        ``.groups`` (wire group names it serves) and
        ``.execute(name, idx) -> labels`` (see
        :class:`repro_torch.serve.transport.RemoteWorkerClient`).
        Super-batches for those groups then shard across hosts as well as local threads;
        a worker failure mid-batch falls back to local execution for its
        shard, unregisters the host, and (with ``health_check_s > 0``) the
        background health checker re-registers it as soon as its ping
        answers again."""
        with self._cv:
            if self._closed:
                raise RuntimeError("OracleService is closed")
            self._remote_workers.append(worker)
            # remote round trips block a thread each: size the pool so every
            # worker host can run concurrently with the local shards.  The
            # old pool is retired, not shut down — the dispatcher may hold a
            # reference mid-window, and submitting to a shut-down pool would
            # fail that window's flushes; retired pools are drained at close()
            pool_size = (self.workers + len(self._remote_workers)
                         + len(self._dead_workers))
            if self._pool is not None:
                self._retired_pools.append(self._pool)
            self._pool = ThreadPoolExecutor(
                max_workers=pool_size, thread_name_prefix="oracle-worker"
            )
            if self._health_thread is None and self.health_check_s > 0:
                self._health_thread = threading.Thread(
                    target=self._health_loop, name="oracle-service-health",
                    daemon=True,
                )
                self._health_thread.start()

    # ---- worker health ------------------------------------------------------

    @staticmethod
    def _worker_alive(worker) -> bool:
        """One health probe.  ``ping`` may return a bool (transport style) or
        raise; hosts without a ping are assumed alive (test doubles)."""
        ping = getattr(worker, "ping", None)
        if ping is None:
            return True
        try:
            return ping() is not False
        except BaseException:  # noqa: BLE001 — an unreachable host is dead
            return False

    @staticmethod
    def _worker_label(worker) -> str:
        addr = getattr(worker, "address", None)
        if isinstance(addr, (tuple, list)) and len(addr) == 2:
            return f"{addr[0]}:{addr[1]}"
        return str(addr) if addr is not None else repr(worker)

    def _mark_worker_dead(self, worker) -> None:
        """Unregister a failing worker host: its groups stop routing to it
        (shards fall back to local) until the health checker sees it answer
        a ping again.  Idempotent — concurrent shard failures of one host
        record one death."""
        with self._cv:
            if worker not in self._remote_workers:
                return
            self._remote_workers.remove(worker)
            self._dead_workers.append(worker)
            self.worker_deaths += 1
        self.tracker.count("service.worker.deaths")
        self.tracker.event("service.worker.dead",
                           worker=self._worker_label(worker))

    def _revive_worker(self, worker) -> bool:
        """Probe one dead worker; on success re-fetch its group set and
        re-register it.  Returns True when the worker rejoined."""
        try:
            if not self._worker_alive(worker):
                return False
            refresh = getattr(worker, "refresh_groups", None)
            if refresh is not None:
                refresh()
        except BaseException:  # noqa: BLE001 — still dead, retry next sweep
            return False
        with self._cv:
            if worker not in self._dead_workers:
                return False
            self._dead_workers.remove(worker)
            self._remote_workers.append(worker)
            self.worker_rejoins += 1
        self.tracker.count("service.worker.rejoins")
        self.tracker.event("service.worker.rejoined",
                           worker=self._worker_label(worker))
        return True

    def check_workers(self) -> None:
        """One health sweep: ping live hosts (a failure unregisters them
        without waiting for a mid-batch shard error) and probe dead ones
        (a success re-registers them, groups re-fetched).  The background
        checker runs it every ``health_check_s``; with ``health_check_s=0``
        the caller runs it when it chooses."""
        with self._cv:
            live = list(self._remote_workers)
            dead = list(self._dead_workers)
        for worker in dead:
            self._revive_worker(worker)
        for worker in live:
            if not self._worker_alive(worker):
                self._mark_worker_dead(worker)

    def _health_loop(self) -> None:
        """Background checker: :meth:`check_workers` every
        ``health_check_s`` until the service closes."""
        while True:
            with self._cv:
                if self._closed:
                    return
            self.check_workers()
            if self._health_stop.wait(self.health_check_s):
                return

    def close(self) -> None:
        """Drain the queue, stop the dispatcher, shut the worker pool, and
        persist the label store (a no-op unless it has a disk root)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._health_stop.set()
        self._dispatcher.join()
        if self._health_thread is not None:
            self._health_thread.join()
        for pool in [self._pool] + self._retired_pools:
            if pool is not None:
                pool.shutdown(wait=True)
        if self.label_store is not None:
            self.label_store.save()

    def __enter__(self) -> "OracleService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        out = {
            "windows": self.windows,
            "segments": self.segments,
            "backend_calls": self.backend_calls,
            "rows_requested": self.rows_requested,
            "rows_labelled": self.rows_labelled,
            "remote_shards": self.remote_shards,
            "remote_failures": self.remote_failures,
            "segments_per_window": round(
                self.segments / max(self.windows, 1), 2
            ),
            # how full windows run vs the max_batch trigger — low fill with
            # high window counts means max_wait_ms closes windows early
            "window_fill_ratio": round(
                self.window_rows / max(self.windows * self.max_batch, 1), 4
            ),
            # fraction of window rows already answered by per-client caches
            # before any backend (or store) work was planned
            "window_dedup_ratio": round(
                1.0 - self.rows_planned / max(self.window_rows, 1), 4
            ),
        }
        if self.index_store is not None:
            out.update(self.index_store.stats())
        if self.label_store is not None:
            out.update(self.label_store.stats())
        return out

    def snapshot(self) -> dict[str, float]:
        """The unified stats surface: one flat ``{dotted.name: float}`` dict
        merging the service's own counters (``service.*``), the attached
        stores (``index_store.*`` / ``label_store.*``), and everything the
        tracker recorded (histogram series expand to ``.p50``/``.p99``/...).
        ``service.window.fill_ratio_recent`` / ``.dedup_ratio_recent`` are
        last-N per-window means — steady state, unlike the lifetime ratios.
        """
        base = {
            "service.windows": float(self.windows),
            "service.segments": float(self.segments),
            "service.backend_calls": float(self.backend_calls),
            "service.rows_requested": float(self.rows_requested),
            "service.rows_labelled": float(self.rows_labelled),
            "service.rows_planned": float(self.rows_planned),
            "service.remote_shards": float(self.remote_shards),
            "service.remote_failures": float(self.remote_failures),
            "service.segments_per_window": (
                self.segments / max(self.windows, 1)
            ),
            "service.window.fill_ratio": (
                self.window_rows / max(self.windows * self.max_batch, 1)
            ),
            "service.window.dedup_ratio": (
                1.0 - self.rows_planned / max(self.window_rows, 1)
            ),
            "service.window.fill_ratio_recent": self._fill_hist.recent_mean(),
            "service.window.dedup_ratio_recent": (
                self._dedup_hist.recent_mean()
            ),
            "service.queue.rows": float(self._queued_rows),
            "service.rate_rows_per_s": float(self._service_rate),
            **{f"service.class.{qc}.rate_rows_per_s": float(r)
               for qc, r in self._class_rates.items()},
            "service.admission.rejected": float(self.admission_rejections),
            "service.worker.live": float(len(self._remote_workers)),
            "service.worker.dead": float(len(self._dead_workers)),
            "service.worker.deaths": float(self.worker_deaths),
            "service.worker.rejoins": float(self.worker_rejoins),
            **{f"service.shard.rate.{lb}": ewma.rate
               for lb, ewma in list(self._shard_rates.items())},
        }
        return merge_snapshots(
            self.tracker.snapshot(),
            self.index_store.snapshot() if self.index_store is not None
            else None,
            self.label_store.snapshot() if self.label_store is not None
            else None,
            base,
        )

    # ---- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return                       # closed and drained
                window = [self._queue.pop(0)]
                rows = window[0].rows
                deadline = time.monotonic() + self.max_wait_s
                while rows < self.max_batch:
                    if self._queue:
                        seg = self._queue.pop(0)
                        window.append(seg)
                        rows += seg.rows
                        continue
                    present = {id(s.oracle) for s in window if not s.raw}
                    waiting = any(
                        id(o) not in present for o in self._clients
                    )
                    if not waiting and self._remote_clients:
                        remote_present = {
                            s.client_id for s in window
                            if s.client_id is not None
                        }
                        waiting = any(c not in remote_present
                                      for c in self._remote_clients)
                    remain = deadline - time.monotonic()
                    if self._closed or remain <= 0 or not waiting:
                        break                    # nobody left to wait for
                    self._cv.wait(remain)
                # the window is now in flight: flushes submitted from here on
                # queue behind it (admission control's backlog view)
                self._queued_rows -= rows
                self._inflight_rows = rows
            t_dispatch = time.perf_counter_ns()
            for seg in window:
                wait = telemetry.record("joinml.queue_wait", seg.t_enqueue,
                                        t_dispatch, seg.query, seg.span_id)
                if self._tracking:
                    self.tracker.observe("service.window.assembly_ms",
                                         wait.seconds * 1e3)
            queries = list({id(seg.query): seg.query for seg in window
                            if seg.query is not None}.values())
            t_proc = time.perf_counter()
            try:
                with telemetry.span("joinml.service.window", queries=queries):
                    self._process(window)
            except BaseException as e:  # noqa: BLE001 — dispatcher must survive
                for seg in window:
                    if not seg.future.done():
                        seg.fail(e)
            finally:
                elapsed = time.perf_counter() - t_proc
                with self._cv:
                    self._inflight_rows = 0
                    # a waiter on the backlog (admission's view) wakes here
                    self._cv.notify_all()
                    if rows and elapsed > 0:
                        # EWMA of the measured service rate (rows/s) feeding
                        # admission control's predicted-wait estimate; the
                        # sample also updates every deadline class present in
                        # this window so each class predicts from its own
                        # history only
                        sample = rows / elapsed
                        self._service_rate = (
                            sample if self._service_rate <= 0.0
                            else 0.7 * self._service_rate + 0.3 * sample
                        )
                        for qc in {seg.qclass for seg in window}:
                            prev = self._class_rates.get(qc, 0.0)
                            self._class_rates[qc] = (
                                sample if prev <= 0.0
                                else 0.7 * prev + 0.3 * sample
                            )
            # pools retired by register_remote_worker are quiescent once the
            # window completes (this thread is their only submitter and
            # _execute awaits every shard), so their threads are reaped here
            # instead of leaking until close()
            with self._lock:
                retired, self._retired_pools = self._retired_pools, []
            for pool in retired:
                pool.shutdown(wait=True)

    # ---- window processing -------------------------------------------------

    def _process(self, window: list[_Segment]) -> None:
        self.windows += 1
        self.segments += len(window)
        rows_w = sum(seg.rows for seg in window)
        self.window_rows += rows_w
        planned_before = self.rows_planned
        plans = self._plan(window)
        # per-window fill/dedup observations: the *_recent snapshot keys and
        # (when a tracker is attached) the service.window.{fill,dedup} series
        fill = rows_w / self.max_batch
        dedup = 1.0 - (self.rows_planned - planned_before) / max(rows_w, 1)
        self._fill_hist.observe(fill)
        self._dedup_hist.observe(dedup)
        if self._tracking:
            self.tracker.observe("service.window.fill", fill)
            self.tracker.observe("service.window.dedup", dedup)
        try:
            groups: dict = {}
            for plan in plans:
                groups.setdefault(plan.seg.group_key(), []).append(plan)
            for key, group in groups.items():
                self._execute_group(key, group)
            for plan in plans:                   # commit in arrival order
                if plan.seg.future.done():       # its group failed
                    continue
                self._commit(plan)
        except BaseException as e:
            # a dispatcher-level failure must not leave store reservations
            # dangling — waiters (possibly in another service sharing the
            # store) would block on them forever
            for plan in plans:
                if plan.store is not None and self.label_store is not None:
                    self.label_store.cancel(plan.store, e)
            raise

    def _plan(self, window: list[_Segment]) -> list[_Plan]:
        """Per-segment dedup + budget check via the shared
        :func:`repro_torch.core.oracle.plan_requests` (exactly local-flush
        semantics), then the store-consultation phase: keys surviving the
        client-cache dedup are split against the shared label store —
        resident hits and in-flight waits are served at commit, only misses
        stay in ``new_keys`` for execution.  Earlier same-oracle segments in
        the window count as cached-to-be with their *full* acquired key set
        (store-served keys land in the client cache at commit too)."""
        plans: list[_Plan] = []
        planned: dict[int, list[np.ndarray]] = {}   # id(oracle) -> key arrays
        store = self.label_store
        for seg in window:
            if seg.raw:
                plans.append(self._plan_raw(seg))
                continue
            o = seg.oracle
            try:
                prior = planned.get(id(o))
                keys_list, n_requested, new_keys = plan_requests(
                    o, seg.requests,
                    extra_planned=np.concatenate(prior) if prior else None,
                )
                if len(new_keys):
                    planned.setdefault(id(o), []).append(new_keys)
                self.rows_planned += len(new_keys)
                plan = _Plan(
                    seg=seg, keys_list=keys_list, n_requested=n_requested,
                    new_keys=new_keys, new_idx=None,
                )
                if store is not None and len(new_keys):
                    enc = _encoding_key(o)
                    if enc is not None:
                        plan.store = store.plan(
                            (o.service_group(), enc), new_keys
                        )
                        plan.new_keys = plan.store.miss_keys
                plan.new_idx = o._decode(plan.new_keys)
                plans.append(plan)
            except BaseException as e:  # noqa: BLE001 — isolate per client
                seg.fail(e)
        return plans

    def _plan_raw(self, seg: _Segment) -> _Plan:
        """Raw (transport) segments are pre-planned by the remote client
        against its own cache and ledger — nothing to dedup or budget-check.
        The store-consultation phase still applies when the tuple indices
        fit the store's bit packing: hits/waits are served at commit and
        only miss rows execute, so remote EXEC answers can be store-served
        (the client's plan/commit semantics never notice)."""
        plan = _Plan(
            seg=seg, keys_list=[], n_requested=seg.rows,
            new_keys=np.empty(0, np.int64), new_idx=seg.idx,
        )
        store = self.label_store
        if store is None or not len(seg.idx):
            self.rows_planned += seg.rows
            return plan
        from .label_store import pack_tuples, unpack_tuples

        row_keys = pack_tuples(seg.idx)
        if row_keys is None:        # indices exceed the packing — skip store
            self.rows_planned += seg.rows
            return plan
        k = seg.idx.shape[1]
        ukeys = np.unique(row_keys)
        self.rows_planned += len(ukeys)
        plan.row_keys = row_keys
        plan.store = store.plan((seg.key, ("pack", k, 63 // k)), ukeys)
        plan.new_keys = plan.store.miss_keys
        plan.new_idx = unpack_tuples(plan.store.miss_keys, k)
        return plan

    def _execute_group(self, key, group: list[_Plan]) -> None:
        """Concatenate a group's new rows into one super-batch, shard it over
        the worker pool (and worker hosts serving this group), and scatter
        labels back per plan.  On success each plan's fresh labels are
        published to the shared store (releasing its reservations); a
        backend error cancels the reservations and fails every segment of
        this group and only this group — cancelled keys become reservable
        again, so the failed flushes retry cleanly."""
        lens = [len(p.new_idx) for p in group]
        total = sum(lens)
        if total == 0:
            return
        idx = np.concatenate([p.new_idx for p in group if len(p.new_idx)])
        fn = group[0].seg.label_fn()        # same group => same pure backend
        try:
            vals = self._execute(fn, idx, key)
            if vals.shape != (total,):
                raise RuntimeError(
                    f"backend returned shape {vals.shape} for {total} rows"
                )
        except BaseException as e:  # noqa: BLE001 — isolate per group
            for p in group:
                if p.store is not None and self.label_store is not None:
                    self.label_store.cancel(p.store, e)
                    p.store = None
                p.seg.fail(e)
            return
        self.rows_labelled += total
        off = 0
        for p, n in zip(group, lens):
            p.vals = vals[off:off + n]
            off += n
            if p.store is not None and self.label_store is not None:
                self.label_store.publish(p.store, p.vals)

    def _eligible_workers(self, key) -> list:
        """Worker hosts that can execute this group.  Only wire groups are
        routable across hosts — a worker host can't run an arbitrary
        in-process ``_label`` closure, it advertises named scorers."""
        if not (isinstance(key, tuple) and len(key) == 2 and key[0] == "wire"):
            return []
        return [w for w in self._remote_workers if key[1] in w.groups]

    def _record_rate(self, label: str, rows: int, seconds: float) -> None:
        """Fold one shard's measured throughput into its executor's EWMA."""
        with self._stats_lock:
            ewma = self._shard_rates.get(label)
            if ewma is None:
                ewma = self._shard_rates[label] = ThroughputEWMA()
        ewma.update(rows, seconds)

    def _capacity_split(self, idx: np.ndarray, labels: list) -> list:
        """Contiguous shards of ``idx`` sized in proportion to each
        executor's measured throughput (rows/s EWMA, see
        :class:`repro_torch.serve.transport.ThroughputEWMA`).

        Executors without a measurement yet are assigned the mean measured
        rate — so the very first super-batch splits uniformly and later
        ones adapt.  The split is contiguous and order-preserving (largest
        remainder apportionment with a one-row floor per shard), so the
        concatenated result is bit-identical to the uniform split it
        replaces regardless of how the sizes skew."""
        n = len(labels)
        with self._stats_lock:
            rates = [
                self._shard_rates[lb].rate
                if lb in self._shard_rates
                and self._shard_rates[lb].samples > 0 else 0.0
                for lb in labels
            ]
        measured = [r for r in rates if r > 0.0]
        if not measured:
            return np.array_split(idx, n)
        fallback = sum(measured) / len(measured)
        weights = np.asarray(
            [r if r > 0.0 else fallback for r in rates], np.float64
        )
        raw = weights * (len(idx) / weights.sum())
        sizes = np.floor(raw).astype(np.int64)
        order = np.argsort(-(raw - sizes), kind="stable")
        for j in range(len(idx) - int(sizes.sum())):
            sizes[order[j % n]] += 1
        for i in range(n):          # one-row floor: steal from the largest
            while sizes[i] == 0:
                sizes[int(np.argmax(sizes))] -= 1
                sizes[i] += 1
        return np.split(idx, np.cumsum(sizes)[:-1])

    def _execute(self, fn: Callable, idx: np.ndarray, key=None) -> np.ndarray:
        """Shard a super-batch across the local thread pool and any worker
        hosts serving the group, each shard sized by the executor's measured
        throughput (``_capacity_split``); shard order is preserved, so
        results are bit-identical regardless of where each shard ran or how
        the sizes skew."""
        remotes = self._eligible_workers(key)
        n_shards = min(self.workers + len(remotes),
                       len(idx) // self.min_shard)
        if self._pool is None or n_shards < 2:
            self.backend_calls += 1
            return np.asarray(self._execute_local(fn, idx), np.float64)
        n_remote = min(len(remotes), n_shards - 1)  # keep >=1 shard local
        labels = [self._worker_label(w) for w in remotes[:n_remote]]
        labels += ["local"] * (n_shards - n_remote)
        shards = self._capacity_split(idx, labels)
        self.backend_calls += n_shards
        # each shard runs in a copy of the window's context: its spans nest
        # under the window's
        futs = [
            self._pool.submit(contextvars.copy_context().run,
                              self._execute_remote, w, key[1], fn, s)
            for w, s in zip(remotes, shards[:n_remote])
        ]
        futs += [self._pool.submit(contextvars.copy_context().run,
                                   self._execute_local, fn, s)
                 for s in shards[n_remote:]]
        return np.concatenate(
            [np.asarray(f.result(), np.float64) for f in futs]
        )

    def _execute_local(self, fn: Callable, shard: np.ndarray):
        """One shard on the local pool, timed into the ``local`` throughput
        EWMA (and ``service.shard.local_ms`` when a tracker is attached)."""
        t0 = time.perf_counter()
        vals = fn(shard)
        dt = time.perf_counter() - t0
        self._record_rate("local", len(shard), dt)
        if self._tracking:
            self.tracker.observe("service.shard.local_ms", dt * 1e3)
        return vals

    def _execute_remote(self, worker, name: str, fn: Callable,
                        shard: np.ndarray) -> np.ndarray:
        """One shard on one worker host; falls back to local execution when
        the host fails mid-batch (labelling is pure, so re-execution is
        always safe) — a dead worker degrades throughput, never a query.
        The failing host is unregistered until its health check passes."""
        try:
            t0 = time.perf_counter()
            vals = np.asarray(worker.execute(name, shard), np.float64)
            if vals.shape != (len(shard),):
                raise RuntimeError(
                    f"worker returned shape {vals.shape} for "
                    f"{len(shard)} rows"
                )
            dt = time.perf_counter() - t0
            self._record_rate(self._worker_label(worker), len(shard), dt)
            if self._tracking:
                self.tracker.observe(
                    f"service.shard.{self._worker_label(worker)}_ms",
                    dt * 1e3,
                )
            with self._stats_lock:
                self.remote_shards += 1
            return vals
        except BaseException:  # noqa: BLE001 — degrade to local execution
            with self._stats_lock:
                self.remote_failures += 1
            self._mark_worker_dead(worker)
            return np.asarray(fn(shard), np.float64)

    def _resolve_store(self, plan: _Plan) -> tuple:
        """Gather the store-served labels for a plan: resident hits (values
        captured at plan time) plus keys reserved by other in-flight plans —
        their tokens resolve to the owner's ``(published_keys, vals)``.
        Within one service tokens are always done by commit time (publish
        precedes commit in ``_process``); across services sharing a store,
        ``result()`` blocks until the owning window publishes or cancels.
        Raises on a cancelled token — the segment then fails retryably."""
        sp = plan.store
        ks, vs = [sp.hit_keys], [sp.hit_vals]
        for token, keys in sp.wait:
            owner_keys, owner_vals = token.result(timeout=120.0)
            pos = np.searchsorted(owner_keys, keys)
            ks.append(keys)
            vs.append(owner_vals[pos])
        return np.concatenate(ks), np.concatenate(vs)

    def _commit(self, plan: _Plan) -> None:
        """Atomic ledger charge + cache merge + per-client result routing via
        the shared :func:`repro_torch.core.oracle.commit_requests`.  Runs only
        after the group's backend execution succeeded, so a failure anywhere
        earlier leaves this client's oracle untouched.  Store-served keys
        merge into the client cache here (advancing ``calls`` exactly like
        serial execution; the charge-once discount lands on ``store_hits``/
        ``store_charge_saved``).  Raw segments have no local oracle to
        commit to — their future resolves to the labels (reassembled in
        request-row order from hits, waits, and executed rows) and the
        remote client commits on its own side."""
        store_keys = store_vals = None
        if plan.store is not None:
            try:
                store_keys, store_vals = self._resolve_store(plan)
            except BaseException as e:  # noqa: BLE001 — owner's call failed
                plan.seg.fail(e)
                return
        self.rows_requested += plan.n_requested
        if plan.seg.raw:
            if plan.row_keys is not None and store_keys is not None:
                # scatter hit + waited + executed values back to row order
                all_keys = np.concatenate([store_keys, plan.new_keys])
                all_vals = np.concatenate([
                    store_vals,
                    plan.vals if plan.vals is not None else np.empty(0),
                ])
                order = np.argsort(all_keys, kind="stable")
                pos = np.searchsorted(all_keys[order], plan.row_keys)
                vals = all_vals[order][pos]
            else:
                vals = plan.vals if plan.vals is not None else np.empty(0)
            plan.seg.future.set_result(np.asarray(vals, np.float64))
            return
        commit_requests(
            plan.seg.oracle, plan.seg.requests, plan.keys_list,
            plan.n_requested, plan.new_keys, plan.vals,
            store_keys=store_keys, store_vals=store_vals,
        )
        plan.seg.future.set_result(None)


def serve_queries(service: OracleService, jobs: list,
                  timeout: Optional[float] = None) -> list:
    """Run ``jobs`` — callables ``job() -> result`` each owning one attached
    oracle — concurrently against one service.  Convenience for entry points
    and benchmarks: threads map 1:1 to queries (each blocks in
    ``future.result()`` while the service batches), results keep job order,
    and the first job exception propagates after all threads join.
    ``timeout`` bounds the wait for all jobs (seconds, ``None`` for none):
    past it, :class:`TimeoutError` names the jobs still running.
    """
    results: list = [None] * len(jobs)
    errors: list = []

    def runner(i: int, job) -> None:
        try:
            results[i] = job()
        except BaseException as e:  # noqa: BLE001 — re-raised after join
            errors.append(e)

    threads = [
        threading.Thread(target=runner, args=(i, job), daemon=True)
        for i, job in enumerate(jobs)
    ]
    for t in threads:
        t.start()
    end = None if timeout is None else time.monotonic() + timeout
    for t in threads:
        t.join(None if end is None else max(end - time.monotonic(), 0.0))
    running = [i for i, t in enumerate(threads) if t.is_alive()]
    if running:
        raise TimeoutError(f"jobs {running} still running after {timeout} s")
    if errors:
        raise errors[0]
    return results


__all__ = ["AdmissionRejected", "OracleService", "serve_queries"]
