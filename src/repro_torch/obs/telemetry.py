"""Typed per-query telemetry: the structured successor to ``QueryResult.detail``.

Historically every pipeline stage appended free-form keys to a nested dict
(``detail["oracle"]["store_hits"]``, ``detail["stratify"]["index_hit"]``, ...),
so consumers had to know each producer's private spelling.
:class:`QueryTelemetry` replaces that with a small dataclass tree — ``oracle``,
``store``, ``stratify``, ``index``, and ``dispatch`` sections with stable field
names — while :class:`TelemetryView` keeps the old dict shape alive as a
deprecation-shimmed *view*: reads materialise from the typed tree and writes
parse back into it, so pre-existing callers (and tests) work unchanged.

Variable-shape producer payloads (per-kernel sweep statistics, baseline-mode
extras) land in ``extra`` dicts on the owning section rather than being lost,
so the round trip ``QueryTelemetry.from_detail(d).as_detail() == d`` holds for
every dict the pipelines emit.

Spans and counters (:func:`span`, :func:`count`) time the port's layers.
``JoinMLEngine.execute`` makes a query active (:func:`query`) and opens its
root span ``joinml.query`` (key ``query_wall_s``); each span inside it adds its duration to the
query's ``timings`` under its key (``joinml.sweep.upload`` ->
``sweep_upload_s``, repeated spans summed) and lands in
``QueryTelemetry.spans`` with its parent and the query's id.  While a
``torch.profiler`` session records, and only then, a span also opens a
``record_function`` of its name on the profiler's host timeline, and every
span and counter goes to the process's bounded :func:`window_log`, on the
profiler's clock (Unix-epoch ns).  With no profiler a span costs two clock
reads and a dict update.  The legacy dict view carries neither spans nor
counters.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import itertools
import threading
import time
import warnings
from collections.abc import MutableMapping
from typing import Any, NamedTuple, Optional, Union

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclasses.dataclass
class OracleTelemetry:
    """Ledger counters from :meth:`repro_torch.core.oracle.Oracle.stats`."""

    calls: int = 0
    requests: int = 0
    batches: int = 0
    charged: int = 0
    dedup_ratio: float = 0.0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StoreTelemetry:
    """Shared label-store effect on this query's ledger."""

    hits: int = 0            # legacy ``oracle.store_hits``
    charge_saved: int = 0    # legacy ``oracle.store_charge_saved``


@dataclasses.dataclass
class StratifyTelemetry:
    """Which stratification path ran and its kernel/sweep statistics."""

    path: str = ""           # dense-sort | sweep | two-pass | index
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class IndexTelemetry:
    """Persistent stratification-index accounting (PR 6)."""

    hit: bool = False
    version: int = 0
    delta_blocks: int = 0
    build_ms: Optional[float] = None   # only set when this query built


@dataclasses.dataclass
class DispatchTelemetry:
    """The auto-dispatch decision (``run_auto``) and its inputs."""

    path: str = ""
    dense_weight_bytes: int = 0
    max_dense_weight_bytes: int = 0
    n_tuples: int = 0
    sweep: bool = True
    sweep_precision: str = "fp32"
    index_store: bool = False
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CascadeTelemetry:
    """Per-stage counters of the multi-fidelity cascade (``core/cascade.py``).

    ``proxy_*`` is the cheap unmetered stage, ``oracle_calls`` the expensive
    ledger the §2 budget binds; ``*_group`` record the distinct
    ``service_group()`` keys the two stages super-batch under."""

    proxy_calls: int = 0
    proxy_requests: int = 0
    oracle_calls: int = 0
    proxy_rows: int = 0
    correction_rows: int = 0
    disagreement_rate: float = 0.0
    proxy_group: str = ""
    oracle_group: str = ""
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


_INDEX_KEYS = ("index_hit", "index_version", "delta_blocks", "index_build_ms")
_SCALAR_FIELDS = ("beta", "num_strata", "stratum_sizes", "pilot_n", "est_mse")


@dataclasses.dataclass
class QueryTelemetry:
    """Typed telemetry for one query execution.

    Sections are ``None`` when the corresponding stage did not run (e.g.
    ``stratify`` on an exact scan, ``index`` without an index store); the
    legacy dict view omits absent sections so ``"stratify" in res.detail``
    keeps meaning what it always did.
    """

    mode: str = ""
    oracle: Optional[OracleTelemetry] = None
    store: Optional[StoreTelemetry] = None
    stratify: Optional[StratifyTelemetry] = None
    index: Optional[IndexTelemetry] = None
    dispatch: Optional[DispatchTelemetry] = None
    cascade: Optional[CascadeTelemetry] = None
    beta: Optional[list] = None
    num_strata: Optional[int] = None
    stratum_sizes: Optional[list] = None
    pilot_n: Optional[list] = None
    est_mse: Optional[float] = None
    timings: dict[str, float] = dataclasses.field(default_factory=dict)
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    # the query's spans and counters (:func:`span`, :func:`count`); not part
    # of the legacy dict view
    query_id: Optional[int] = None
    spans: list = dataclasses.field(default_factory=list)
    counters: dict[str, int] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ parse
    @classmethod
    def from_detail(cls, detail: dict | None) -> "QueryTelemetry":
        """Parse a legacy ``QueryResult.detail`` dict into the typed tree."""
        t = cls()
        for key, value in (detail or {}).items():
            t._set_legacy(key, value)
        return t

    def _set_legacy(self, key: str, value) -> None:
        if key == "mode":
            self.mode = str(value)
        elif key == "oracle" and isinstance(value, dict):
            self._parse_oracle(value)
        elif key == "stratify" and isinstance(value, dict):
            self._parse_stratify(value)
        elif key == "dispatch" and isinstance(value, dict):
            self._parse_dispatch(value)
        elif key == "cascade" and isinstance(value, dict):
            self._parse_cascade(value)
        elif key == "timings" and isinstance(value, dict):
            self.timings = dict(value)
        elif key in _SCALAR_FIELDS:
            setattr(self, key, value)
        else:
            self.extra[key] = value

    def _parse_oracle(self, stats: dict) -> None:
        stats = dict(stats)
        if "store_hits" in stats or "store_charge_saved" in stats:
            self.store = StoreTelemetry(
                hits=int(stats.pop("store_hits", 0)),
                charge_saved=int(stats.pop("store_charge_saved", 0)),
            )
        known = {f.name for f in dataclasses.fields(OracleTelemetry)} - {"extra"}
        self.oracle = OracleTelemetry(
            **{k: stats.pop(k) for k in list(stats) if k in known},
            extra=stats,
        )

    def _parse_stratify(self, meta: dict) -> None:
        meta = dict(meta)
        if "index_hit" in meta:
            self.index = IndexTelemetry(
                hit=bool(meta.pop("index_hit")),
                version=int(meta.pop("index_version", 0)),
                delta_blocks=int(meta.pop("delta_blocks", 0)),
                build_ms=meta.pop("index_build_ms", None),
            )
        self.stratify = StratifyTelemetry(path=str(meta.pop("path", "")),
                                          extra=meta)

    def _parse_dispatch(self, d: dict) -> None:
        d = dict(d)
        known = {f.name for f in dataclasses.fields(DispatchTelemetry)} - {"extra"}
        self.dispatch = DispatchTelemetry(
            **{k: d.pop(k) for k in list(d) if k in known},
            extra=d,
        )

    def _parse_cascade(self, d: dict) -> None:
        d = dict(d)
        known = {f.name for f in dataclasses.fields(CascadeTelemetry)} - {"extra"}
        self.cascade = CascadeTelemetry(
            **{k: d.pop(k) for k in list(d) if k in known},
            extra=d,
        )

    # ------------------------------------------------------------ materialise
    def as_detail(self) -> dict:
        """The legacy nested-dict shape, rebuilt from the typed tree."""
        d: dict[str, Any] = {}
        if self.mode:
            d["mode"] = self.mode
        d.update(self.extra)
        if self.stratify is not None:
            meta: dict[str, Any] = {"path": self.stratify.path}
            meta.update(self.stratify.extra)
            if self.index is not None:
                meta["index_hit"] = self.index.hit
                meta["index_version"] = self.index.version
                meta["delta_blocks"] = self.index.delta_blocks
                if self.index.build_ms is not None:
                    meta["index_build_ms"] = self.index.build_ms
            d["stratify"] = meta
        for name in _SCALAR_FIELDS:
            value = getattr(self, name)
            if value is not None:
                d[name] = value
        if self.timings:
            d["timings"] = self.timings
        if self.oracle is not None:
            stats: dict[str, Any] = {
                "calls": self.oracle.calls,
                "requests": self.oracle.requests,
                "batches": self.oracle.batches,
                "charged": self.oracle.charged,
            }
            if self.store is not None:
                stats["store_hits"] = self.store.hits
                stats["store_charge_saved"] = self.store.charge_saved
            stats["dedup_ratio"] = self.oracle.dedup_ratio
            stats.update(self.oracle.extra)
            d["oracle"] = stats
        if self.dispatch is not None:
            dd = {f.name: getattr(self.dispatch, f.name)
                  for f in dataclasses.fields(DispatchTelemetry)
                  if f.name != "extra"}
            dd.update(self.dispatch.extra)
            d["dispatch"] = dd
        if self.cascade is not None:
            cc = {f.name: getattr(self.cascade, f.name)
                  for f in dataclasses.fields(CascadeTelemetry)
                  if f.name != "extra"}
            cc.update(self.cascade.extra)
            d["cascade"] = cc
        return d


_warned = False


def _warn_detail_deprecated() -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "QueryResult.detail is deprecated; use the typed "
            "QueryResult.telemetry tree (repro_torch.obs.QueryTelemetry) instead",
            DeprecationWarning, stacklevel=3,
        )


class TelemetryView(MutableMapping):
    """Dict-shaped, write-through view over a :class:`QueryTelemetry`.

    Reads materialise the legacy nested shape from the typed tree; top-level
    writes (``view["dispatch"] = {...}``) parse back into it.  Nested values
    are returned as plain dicts — mutate through a top-level assignment, or
    better, through ``result.telemetry`` directly.
    """

    __slots__ = ("_t",)

    def __init__(self, telemetry: QueryTelemetry):
        self._t = telemetry

    def __getitem__(self, key: str):
        d = self._t.as_detail()
        return d[key]

    def __setitem__(self, key: str, value) -> None:
        self.__delitem__(key) if key in self else None
        self._t._set_legacy(key, value)

    def __delitem__(self, key: str) -> None:
        t = self._t
        if key == "mode":
            t.mode = ""
        elif key == "oracle":
            t.oracle = t.store = None
        elif key == "stratify":
            t.stratify = t.index = None
        elif key == "dispatch":
            t.dispatch = None
        elif key == "cascade":
            t.cascade = None
        elif key == "timings":
            t.timings = {}
        elif key in _SCALAR_FIELDS:
            setattr(t, key, None)
        elif key in t.extra:
            del t.extra[key]
        else:
            raise KeyError(key)

    def __iter__(self):
        return iter(self._t.as_detail())

    def __len__(self) -> int:
        return len(self._t.as_detail())

    def __repr__(self) -> str:
        return f"TelemetryView({self._t.as_detail()!r})"


# ----------------------------------------------------------------------------
# Spans and counters
# ----------------------------------------------------------------------------

class Span(NamedTuple):
    """One timed interval.  In ``QueryTelemetry.spans`` its ends are
    ``time.perf_counter_ns`` readings; in :func:`window_log` they are Unix-epoch
    ns, the profiler's clock.  ``query_id`` is None outside a query, and a
    tuple of ids for a service window that holds several queries' rows."""

    name: str
    start: int
    end: int
    span_id: int
    parent_id: Optional[int]
    query_id: Union[int, tuple, None]

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


_SPAN_IDS = itertools.count(1)
_QUERY_IDS = itertools.count(1)
_PREFIX = "joinml."


_ROOT = "joinml.query"


@functools.lru_cache(maxsize=None)
def timing_key(name: str) -> str:
    """``joinml.sweep.upload`` -> ``sweep_upload_s``: a span's key in a
    query's ``timings``.  The root ``joinml.query`` is ``query_wall_s``, the
    query's own wall time."""
    if name == _ROOT:
        return "query_wall_s"
    if name.startswith(_PREFIX):
        name = name[len(_PREFIX):]
    return name.replace(".", "_") + "_s"


class ActiveQuery:
    """The timings, spans and counters of one executing query.  Spans may
    close on another thread (a service window), hence the lock."""

    def __init__(self):
        self.id = next(_QUERY_IDS)
        self.timings: dict[str, float] = {}
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, s: Span) -> None:
        key = timing_key(s.name)
        with self._lock:
            self.timings[key] = self.timings.get(key, 0.0) + s.seconds
            self.spans.append(s)

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def attach(self, res):
        """Lay the query's timings, spans and counters on a result's
        telemetry; returns the result."""
        t = res.telemetry
        with self._lock:
            t.timings = dict(self.timings)
            t.spans = list(self.spans)
            t.counters = dict(self.counters)
        t.query_id = self.id
        return res


_QUERY: contextvars.ContextVar[Optional[ActiveQuery]] = contextvars.ContextVar(
    "joinml_query", default=None)
_PARENT: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "joinml_span", default=None)


def recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process.  The
    profiler's own flag is per thread; this one holds for every thread, so
    a service worker's spans and counters reach the log too.  A torch
    without the flag reads as not recording."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def current() -> tuple:
    """``(active query or None, innermost open span id or None)`` of the
    calling context: what a hand-off to another thread carries."""
    return _QUERY.get(), _PARENT.get()


class _Log:
    """Spans and counter sums recorded while a profiler session records:
    bounded, process-wide.  Device counters stay device tensors, summed on
    their device, until the log is read."""

    def __init__(self, max_spans: int = 1 << 16):
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self._counters: dict[str, int] = {}
        self._device: dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()
        self._anchor: Optional[int] = None

    def add(self, s: Span) -> None:
        if self._anchor is None:
            # one anchor per process from perf_counter to the Unix epoch
            self._anchor = time.time_ns() - time.perf_counter_ns()
        a = self._anchor
        with self._lock:
            self._spans.append(s._replace(start=s.start + a, end=s.end + a))

    def count(self, name: str, n) -> None:
        with self._lock:
            if isinstance(n, torch.Tensor):
                key = (name, n.device)
                prev = self._device.get(key)
                self._device[key] = n.detach() if prev is None else prev + n.detach()
            else:
                self._counters[name] = self._counters.get(name, 0) + int(n)

    def read(self) -> "WindowLog":
        with self._lock:
            spans = list(self._spans)
            counters = dict(self._counters)
            device = list(self._device.items())
        by_dev: dict = {}
        for (name, dev), t in device:
            by_dev.setdefault(dev, []).append((name, t))
        for items in by_dev.values():
            # one copy to the host a device
            vals = torch.stack([t for _, t in items]).tolist()
            for (name, _), v in zip(items, vals):
                counters[name] = counters.get(name, 0) + int(v)
        return WindowLog(spans, counters)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._device.clear()


@dataclasses.dataclass
class WindowLog:
    """What :func:`window_log` returns: the logged spans (Unix-epoch ns) and
    each counter's sum."""

    spans: list
    counters: dict


_LOG = _Log()


def window_log() -> WindowLog:
    """The spans and counters recorded under ``torch.profiler`` since the
    last :func:`clear_window_log` (the oldest spans drop past 65,536)."""
    return _LOG.read()


def clear_window_log() -> None:
    _LOG.clear()


@functools.lru_cache(maxsize=None)
def _annotation_ops() -> tuple:
    """The two ops behind ``torch.profiler.record_function`` (a user
    annotation on the profiler's host timeline), called directly: the
    Python wrapper's work would lie between a span's clock read and the
    event's stamp."""
    ops = torch.ops.profiler
    return (ops._record_function_enter_new.default,
            ops._record_function_exit._RecordFunction)


class span:
    """``with span("joinml.<layer>"):`` times a layer (see the module
    docstring).  ``queries`` (ActiveQuery objects) makes the span theirs
    instead of the calling context's query: a service window holding their
    rows, opened on the service's thread.  After the block, ``seconds`` is
    its duration."""

    __slots__ = ("name", "queries", "start", "end", "span_id", "_parent", "_token",
                 "_rf")

    def __init__(self, name: str, queries: Optional[list] = None):
        self.name = name
        self.queries = queries
        self.start = self.end = 0

    def __enter__(self) -> "span":
        if self.queries is None:
            q = _QUERY.get()
            self.queries = [q] if q is not None else []
        self._parent = _PARENT.get()
        self.span_id = next(_SPAN_IDS)
        self._token = _PARENT.set(self.span_id)
        self._rf = None
        if recording() and torch._C._autograd._profiler_enabled():
            # the clock is read just before the profiler's event opens and
            # just before it closes, with nothing else between: the event
            # stamps its ends inside the op, and a thread switched out
            # between the two reads would part them
            enter, _ = _annotation_ops()
            self.start = time.perf_counter_ns()
            self._rf = enter(self.name, None)
        else:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            _, leave = _annotation_ops()
            with torch._C.DisableTorchFunctionSubclass():
                self.end = time.perf_counter_ns()
                leave(self._rf)
        else:
            self.end = time.perf_counter_ns()
        _PARENT.reset(self._token)
        _finish(self.name, self.start, self.end, self.span_id, self._parent,
                self.queries)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def _finish(name, start, end, span_id, parent, queries) -> Span:
    qid = (None if not queries else queries[0].id if len(queries) == 1
           else tuple(q.id for q in queries))
    s = Span(name, start, end, span_id, parent, qid)
    for q in queries:
        q.add(s)
    if recording():
        _LOG.add(s)
    return s


def record(name: str, start: int, end: int, query: Optional[ActiveQuery] = None,
           parent: Optional[int] = None) -> Span:
    """A span whose ends (``perf_counter_ns``) were read elsewhere, such as
    a flush's wait from its client's thread to the service's dispatch."""
    return _finish(name, start, end, next(_SPAN_IDS), parent,
                   [query] if query is not None else [])


def count(name: str, n: int) -> None:
    """Add ``n`` to the active query's counter ``name`` and, while the log
    records, to the log's."""
    q = _QUERY.get()
    if q is not None:
        q.count(name, n)
    if recording():
        _LOG.count(name, n)


_TAPS: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "repro_torch_taps", default=None)


@contextlib.contextmanager
def tapping(*names: str):
    """Collect, in the calling context, what the program hands to
    :func:`tap` under ``names`` (values as they are, on their device, in
    the order handed): yields ``{name: [value, ...]}``.  What a check
    replays to see the program's own intermediate decisions, such as the
    dropless MoE's ``moe.routes``; outside such a block :func:`tap` costs
    one context lookup."""
    taps = {n: [] for n in names}
    token = _TAPS.set(taps)
    try:
        yield taps
    finally:
        _TAPS.reset(token)


def tap(name: str, value) -> None:
    """Hand ``value`` to the enclosing :func:`tapping` block that collects
    ``name``, if any."""
    taps = _TAPS.get()
    if taps is not None and name in taps:
        taps[name].append(value)


def log_count(name: str, n) -> None:
    """Add ``n`` (an int, or a tensor summed on its device with no copy to
    the host) to the log's counter ``name`` alone, while the log records."""
    if recording():
        _LOG.count(name, n)


@contextlib.contextmanager
def query():
    """Make a query active for the block, with its root span
    ``joinml.query``; inside an active query, the active one."""
    q = _QUERY.get()
    if q is not None:
        yield q
        return
    q = ActiveQuery()
    token = _QUERY.set(q)
    try:
        with span(_ROOT):
            yield q
    finally:
        _QUERY.reset(token)


def traced_query(fn):
    """Run ``fn`` inside :func:`query` and lay the query's timings, spans and
    counters on the ``QueryResult`` it returns."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with query() as q:
            res = fn(*args, **kwargs)
        return q.attach(res)

    return run
