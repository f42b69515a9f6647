"""Pluggable metric trackers for the serving data plane.

The serving substrate (``OracleService``, the TCP transport, the label and
index stores) emits three kinds of signals: monotone **counters** (windows
dispatched, reconnects, admission rejections), point-in-time **gauges**
(in-flight request depth), and latency/ratio **observations** that need
quantiles (window assembly latency, per-host shard latency, per-class
end-to-end flush latency).  A :class:`Tracker` receives all three through a
small protocol — ``count`` / ``gauge`` / ``observe`` / ``event`` — and folds
them into one flat ``snapshot() -> dict[str, float]`` with namespaced dotted
keys (``service.window.fill``, ``transport.rtt_ms.p99``, ...).

Three implementations ship here:

- :class:`NoopTracker` — the default everywhere; every hook is a no-op so
  uninstrumented paths pay one virtual call and nothing else.
- :class:`InMemoryTracker` — thread-safe dicts of counters/gauges plus
  :class:`StreamingHistogram` per observed series: bounded memory (a ring of
  the last-N observations) with lifetime count/sum/min/max, so ``p50``/``p99``
  reflect steady state rather than warmup.
- :class:`JsonlTracker` — an :class:`InMemoryTracker` that additionally
  appends one JSON object per signal to a file; CI uploads this as the
  smoke-bench artifact.

Observations are wall-clock agnostic: callers time with
``time.perf_counter()`` and pass milliseconds (suffix the series ``_ms``) or
dimensionless ratios.  All trackers are safe to share across the dispatcher,
worker-pool, health-check, and client threads.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Iterable, Protocol, runtime_checkable


class StreamingHistogram:
    """Streaming quantile sketch with bounded memory.

    Keeps lifetime ``count``/``total``/``min``/``max`` plus a ring buffer of
    the last ``window`` observations; quantiles are computed over the ring, so
    ``p50``/``p99`` track the *recent* distribution (steady state) while
    ``mean`` stays lifetime.  Not thread-safe on its own — the owning tracker
    serialises access.
    """

    __slots__ = ("window", "count", "total", "vmin", "vmax", "_ring", "_pos")

    def __init__(self, window: int = 512):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.window = window
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._ring: list[float] = []
        self._pos = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if len(self._ring) < self.window:
            self._ring.append(value)
        else:
            self._ring[self._pos] = value
            self._pos = (self._pos + 1) % self.window

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Quantile over the retained window (nearest-rank interpolation)."""
        if not self._ring:
            return 0.0
        vals = sorted(self._ring)
        idx = q * (len(vals) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(vals) - 1)
        frac = idx - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def recent_mean(self) -> float:
        """Mean over the retained window only (the last-N observations)."""
        if not self._ring:
            return 0.0
        return sum(self._ring) / len(self._ring)

    def snapshot(self, name: str) -> dict[str, float]:
        if not self.count:
            return {}
        return {
            f"{name}.count": float(self.count),
            f"{name}.mean": self.mean,
            f"{name}.p50": self.quantile(0.50),
            f"{name}.p99": self.quantile(0.99),
            f"{name}.max": self.vmax,
        }


@runtime_checkable
class Tracker(Protocol):
    """What the serving layers require of a metrics sink.

    Implementations must be thread-safe: the dispatcher, pool workers, the
    health-check thread, and client threads all emit concurrently.
    """

    def count(self, name: str, value: int = 1) -> None:
        """Add ``value`` to the monotone counter ``name``."""

    def gauge(self, name: str, value: float) -> None:
        """Set the point-in-time gauge ``name``."""

    def observe(self, name: str, value: float) -> None:
        """Record one sample of the distribution series ``name``."""

    def event(self, name: str, **fields) -> None:
        """Record a discrete occurrence (worker death/rejoin, reconnect)."""

    def snapshot(self) -> dict[str, float]:
        """Flat ``{dotted.name: value}`` view of everything recorded."""

    def close(self) -> None:
        """Flush and release any underlying resources."""


class NoopTracker:
    """Default tracker: every hook is a no-op (the uninstrumented fast path)."""

    def count(self, name: str, value: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def snapshot(self) -> dict[str, float]:
        return {}

    def close(self) -> None:
        pass


NULL_TRACKER = NoopTracker()


class InMemoryTracker:
    """Thread-safe in-process tracker: counters, gauges, and one bounded
    :class:`StreamingHistogram` per observed series."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._window = window
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, StreamingHistogram] = {}
        self._events: dict[str, int] = {}

    def count(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = StreamingHistogram(self._window)
            hist.observe(value)

    def event(self, name: str, **fields) -> None:
        with self._lock:
            self._events[name] = self._events.get(name, 0) + 1

    def histogram(self, name: str) -> StreamingHistogram | None:
        """The live histogram for ``name`` (None if never observed)."""
        with self._lock:
            return self._hists.get(name)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            out: dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            for name, n in self._events.items():
                out[f"{name}.events"] = float(n)
            for name, hist in self._hists.items():
                out.update(hist.snapshot(name))
        return out

    def close(self) -> None:
        pass


class JsonlTracker(InMemoryTracker):
    """An :class:`InMemoryTracker` that also appends one JSON object per
    signal to ``path`` — the artifact CI's smoke-bench job uploads.

    Lines are ``{"ts": epoch_s, "kind": count|gauge|observe|event,
    "name": ..., "value": ...}`` plus any event fields; ``snapshot`` rows are
    not written (re-derive them from the stream or call :meth:`snapshot`).
    """

    def __init__(self, path, window: int = 512, flush_every: int = 64):
        super().__init__(window=window)
        self._path = str(path)
        self._file = open(self._path, "a", encoding="utf-8")
        self._flush_every = max(1, flush_every)
        self._written = 0
        self._io_lock = threading.Lock()

    @property
    def path(self) -> str:
        return self._path

    def _emit(self, kind: str, name: str, value, fields: dict | None = None):
        rec = {"ts": time.time(), "kind": kind, "name": name, "value": value}
        if fields:
            rec.update(fields)
        line = json.dumps(rec, default=str)
        with self._io_lock:
            if self._file.closed:
                return
            self._file.write(line + "\n")
            self._written += 1
            if self._written % self._flush_every == 0:
                self._file.flush()

    def count(self, name: str, value: int = 1) -> None:
        super().count(name, value)
        self._emit("count", name, value)

    def gauge(self, name: str, value: float) -> None:
        super().gauge(name, value)
        self._emit("gauge", name, float(value))

    def observe(self, name: str, value: float) -> None:
        super().observe(name, value)
        self._emit("observe", name, float(value))

    def event(self, name: str, **fields) -> None:
        super().event(name, **fields)
        self._emit("event", name, 1, fields)

    def close(self) -> None:
        with self._io_lock:
            if not self._file.closed:
                self._file.flush()
                self._file.close()


def make_tracker(kind: str, path=None, window: int = 512):
    """Factory used by launchers/benches: ``none`` | ``memory`` | ``jsonl``."""
    if kind in (None, "", "none", "noop"):
        return NoopTracker()
    if kind == "memory":
        return InMemoryTracker(window=window)
    if kind == "jsonl":
        if path is None:
            raise ValueError("jsonl tracker requires an output path")
        return JsonlTracker(path, window=window)
    raise ValueError(f"unknown tracker kind {kind!r}")


def merge_snapshots(*parts: Iterable[tuple[str, float]] | dict) -> dict[str, float]:
    """Merge snapshot dicts left-to-right (later parts win on key clashes)."""
    out: dict[str, float] = {}
    for part in parts:
        if part:
            out.update(part)
    return out
