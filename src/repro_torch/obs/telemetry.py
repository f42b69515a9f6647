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
"""
from __future__ import annotations

import dataclasses
import warnings
from collections.abc import MutableMapping
from typing import Any, Optional


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
