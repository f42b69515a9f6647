"""JoinML query front-end (paper Fig. 1 syntax).

Parses::

    SELECT {AVG|SUM|COUNT|MIN|MAX|MEDIAN}(expr)
    FROM t1 JOIN t2 [JOIN t3 ...]
    ON NL('...') [AND ...]
    ORACLE BUDGET b WITH PROBABILITY p

into a :class:`repro_torch.core.types.Query` against a registered catalog of tables
(embeddings + attribute columns) and an Oracle, then executes it with the
selected algorithm (BAS by default).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Union

import numpy as np

from ..device import resolve_device
from ..obs.telemetry import traced_query
from . import baselines, bas, bas_streaming, dispatch
from .oracle import Oracle
from .types import Agg, AttrFn, BASConfig, JoinSpec, Query, QueryResult


@dataclasses.dataclass
class Table:
    name: str
    embeddings: np.ndarray                 # (N, d) unit-normalised
    columns: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.embeddings.shape[0])


class Catalog:
    def __init__(self):
        self.tables: dict[str, Table] = {}

    def register(self, table: Table) -> None:
        self.tables[table.name] = table

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]


_NL_RE = r"NL\s*\(\s*'[^']*'\s*\)"
_QUERY_RE = re.compile(
    r"SELECT\s+(?P<agg>AVG|SUM|COUNT|MIN|MAX|MEDIAN)\s*\(\s*(?P<expr>[^)]*)\s*\)\s+"
    r"FROM\s+(?P<tables>.+?)\s+ON\s+"
    rf"(?P<on>{_NL_RE}(?:\s+AND\s+{_NL_RE})*)"
    r"(?:\s+ORACLE\s+BUDGET\s+(?P<budget>\d+))?"
    r"(?:\s+WITH\s+PROBABILITY\s+(?P<prob>[\d.]+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_NL_EXTRACT_RE = re.compile(r"NL\s*\(\s*'([^']*)'\s*\)", re.IGNORECASE)


@dataclasses.dataclass
class ParsedQuery:
    agg: Agg
    expr: str
    table_names: list[str]
    nl_conditions: list[str]   # one per join edge (or a single conjoint one)
    budget: Optional[int]
    confidence: Optional[float]

    @property
    def nl_condition(self) -> str:
        """First (or only) predicate — kept for single-predicate callers."""
        return self.nl_conditions[0]


def parse_query(sql: str) -> ParsedQuery:
    """Parse ``... ON NL('...') [AND NL('...') ...]`` — a conjunction carries
    one predicate per join edge (k tables -> k-1 edges), matching the paper's
    multi-way chain-join syntax; a single predicate applies to every edge."""
    m = _QUERY_RE.match(" ".join(sql.split()))
    if not m:
        raise ValueError(f"cannot parse JoinML query: {sql!r}")
    names = [
        t.strip() for t in re.split(r"\s+JOIN\s+", m.group("tables"), flags=re.I)
    ]
    conditions = _NL_EXTRACT_RE.findall(m.group("on"))
    if len(conditions) not in (1, len(names) - 1):
        raise ValueError(
            f"{len(conditions)} NL predicates for {len(names)} tables: a "
            f"conjunction must supply one predicate per join edge "
            f"({len(names) - 1}) or a single predicate for all edges"
        )
    return ParsedQuery(
        agg=Agg[m.group("agg").upper()],
        expr=m.group("expr").strip(),
        table_names=names,
        nl_conditions=conditions,
        budget=int(m.group("budget")) if m.group("budget") else None,
        confidence=float(m.group("prob")) if m.group("prob") else None,
    )


def _compile_expr(expr: str, tables: list[Table]) -> Optional[AttrFn]:
    """Compile the aggregate expression into g(idx).

    Supports '*', 'k' (constant), 'tN.col', 'tA.col - tB.col',
    'ABS(tA.col - tB.col)'.  Table refs are by name or alias position.
    """
    expr = expr.strip()
    if expr in ("*", "", "1"):
        return None
    name_to_pos = {t.name: i for i, t in enumerate(tables)}

    def col(ref: str) -> tuple[int, np.ndarray]:
        tname, cname = ref.strip().split(".")
        pos = name_to_pos[tname]
        return pos, tables[pos].columns[cname]

    m = re.match(r"ABS\s*\(\s*(.+)\s*\)\s*$", expr, re.I)
    absolute = False
    if m:
        absolute = True
        expr = m.group(1)
    m = re.match(r"([\w.]+)\s*-\s*([\w.]+)\s*$", expr)
    if m:
        (p1, c1), (p2, c2) = col(m.group(1)), col(m.group(2))

        def g(idx: np.ndarray) -> np.ndarray:
            v = c1[idx[:, p1]] - c2[idx[:, p2]]
            return np.abs(v) if absolute else v

        return g
    m = re.match(r"([\w.]+)$", expr)
    if m and "." in expr:
        p1, c1 = col(expr)

        def g(idx: np.ndarray) -> np.ndarray:
            v = c1[idx[:, p1]].astype(np.float64)
            return np.abs(v) if absolute else v

        return g
    raise ValueError(f"unsupported aggregate expression: {expr!r}")


class JoinMLEngine:
    """Executes JoinML queries.  ``oracle_factory(nl_condition, table_names)``
    supplies the Oracle for a given join predicate (e.g. an ArrayOracle in
    tests).  ``nl_condition`` is a single string for one predicate, or the
    list of per-edge predicates when the query conjoins ``NL('...') AND
    NL('...')`` (one per join edge).

    ``proxy_factory`` (same signature as ``oracle_factory``) supplies the
    cheap proxy oracle for the multi-fidelity cascade
    (``method="bas-cascade"`` or ``cfg.cascade``); without one, the cascade
    falls back to the thresholded-similarity proxy
    (:func:`repro_torch.core.cascade.similarity_proxy`).

    ``index_store`` (:class:`repro_torch.core.index.IndexStore`) makes
    repeat and concurrent queries on the same registered tables stratify
    from one persistent sweep artifact: ``method="auto"`` routes through a
    fresh resident artifact when one exists, and ``method="bas-streaming"``
    / ``"bas-cascade"`` resolve (building on first miss) through the store.

    ``device`` (default ``"cuda"``; raises without a card) is where the
    similarity passes and kernels run.  Every method of the reference engine
    is ported."""

    def __init__(
        self,
        catalog: Catalog,
        oracle_factory: Callable[[Union[str, list[str]], list[str]], Oracle],
        cfg: Optional[BASConfig] = None,
        index_store=None,
        proxy_factory: Optional[
            Callable[[Union[str, list[str]], list[str]], Oracle]
        ] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.catalog = catalog
        self.oracle_factory = oracle_factory
        self.cfg = cfg or BASConfig()
        self.index_store = index_store
        self.proxy_factory = proxy_factory

    def build(self, sql: str, budget: Optional[int] = None,
              confidence: Optional[float] = None) -> Query:
        pq = parse_query(sql)
        tables = [self.catalog[n] for n in pq.table_names]
        spec = JoinSpec(embeddings=[t.embeddings for t in tables])
        g = _compile_expr(pq.expr, tables)
        nl = (pq.nl_conditions if len(pq.nl_conditions) > 1
              else pq.nl_conditions[0])
        return Query(
            spec=spec,
            agg=pq.agg,
            oracle=self.oracle_factory(nl, pq.table_names),
            g=g,
            budget=budget or pq.budget or 10000,
            confidence=confidence or pq.confidence or 0.95,
            proxy=(self.proxy_factory(nl, pq.table_names)
                   if self.proxy_factory is not None else None),
        )

    @traced_query
    def execute(self, sql: str, method: str = "auto", seed: int = 0,
                budget: Optional[int] = None,
                confidence: Optional[float] = None) -> QueryResult:
        """Execute a JoinML query.  ``method="auto"`` (default) routes BAS
        through the memory-aware dispatcher: dense when the flat chain-weight
        array fits under ``cfg.max_dense_weight_bytes``, streaming otherwise.
        ``"bas"`` / ``"bas-streaming"`` force a path explicitly.

        The query is active for the call (``repro_torch.obs.telemetry``):
        its root span ``joinml.query`` and every span under it land in
        ``result.telemetry.spans`` and ``timings``."""
        q = self.build(sql, budget, confidence)
        if method == "auto":
            return dispatch.run_auto(q, self.cfg, seed=seed,
                                     index_store=self.index_store,
                                     device=self.device)
        if method == "bas":
            return bas.run_bas(q, self.cfg, seed=seed, device=self.device)
        if method == "bas-streaming":
            return bas_streaming.run_bas_streaming(
                q, self.cfg, seed=seed, index_store=self.index_store,
                device=self.device,
            )
        if method == "bas-cascade":
            from . import cascade

            return cascade.run_bas_cascade(
                q, self.cfg, seed=seed, index_store=self.index_store,
                device=self.device,
            )
        if method == "wwj":
            return baselines.run_wwj(q, self.cfg, seed=seed, device=self.device)
        if method == "uniform":
            return baselines.run_uniform(q, seed=seed, device=self.device)
        if method == "abae":
            return baselines.run_abae(q, self.cfg, seed=seed, device=self.device)
        if method == "blazeit":
            return baselines.run_blazeit(q, self.cfg, seed=seed,
                                         device=self.device)
        raise ValueError(f"unknown method {method!r}")
