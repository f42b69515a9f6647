"""Core datatypes for the JoinML-X query engine.

The vocabulary follows the paper: a *join spec* is a chain join over k tables of
unstructured records, each record represented by a unit-normalised embedding
vector.  The *Oracle* labels k-tuples (expensive); *similarity* scores are the
cheap proxy.  A query asks for an aggregate over the joined tuples with an
Oracle budget ``b`` and a CI coverage probability ``p``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence

import numpy as np


class Agg(enum.Enum):
    COUNT = "count"
    SUM = "sum"
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    MEDIAN = "median"


@dataclasses.dataclass(frozen=True)
class ConfidenceInterval:
    lo: float
    hi: float
    p: float  # nominal coverage

    @property
    def width(self) -> float:
        return float(self.hi - self.lo)

    def contains(self, value: float) -> bool:
        return bool(self.lo <= value <= self.hi)


class QueryResult:
    """One query's answer plus typed execution telemetry.

    ``telemetry`` (a :class:`repro_torch.obs.QueryTelemetry`) is the source of
    truth for everything the pipeline recorded — which path ran, timings,
    ledger counters, index/store accounting.  The legacy ``detail`` dict is
    kept as a deprecated write-through *view* of that tree: constructing with
    ``detail={...}`` parses into the tree, and ``result.detail[...]`` reads
    and writes through it, so pre-redesign callers keep working.
    """

    __slots__ = ("estimate", "ci", "oracle_calls", "telemetry")

    def __init__(self, estimate: float, ci: ConfidenceInterval,
                 oracle_calls: int, detail: Optional[dict] = None,
                 telemetry: Optional["QueryTelemetry"] = None):  # noqa: F821
        from repro_torch.obs.telemetry import QueryTelemetry

        self.estimate = estimate
        self.ci = ci
        self.oracle_calls = oracle_calls
        if telemetry is None:
            telemetry = QueryTelemetry.from_detail(detail)
        elif detail:
            raise TypeError("pass either detail= or telemetry=, not both")
        self.telemetry = telemetry

    @property
    def detail(self) -> "TelemetryView":  # noqa: F821 (repro_torch.obs.telemetry)
        """Deprecated dict view of :attr:`telemetry` (reads/writes through)."""
        from repro_torch.obs.telemetry import TelemetryView, _warn_detail_deprecated

        _warn_detail_deprecated()
        return TelemetryView(self.telemetry)

    def __repr__(self) -> str:
        return (f"QueryResult(estimate={self.estimate!r}, ci={self.ci!r}, "
                f"oracle_calls={self.oracle_calls!r})")

    def error_ratio(self, truth: float) -> float:
        """Paper §7.2 metric: |mu_hat - mu| / (CI half width)."""
        half = self.ci.width / 2.0
        if half <= 0:
            return float("inf") if abs(self.estimate - truth) > 0 else 0.0
        return abs(self.estimate - truth) / half


@dataclasses.dataclass(frozen=True)
class BASConfig:
    """Hyper-parameters of Blocking-augmented Sampling (paper Alg. 4 / §5.5)."""

    alpha: float = 0.2            # maximum blocking ratio (top alpha*b pairs)
    pilot_fraction: float = 0.2   # b1 = pilot_fraction * b, b2 = rest
    min_strata: int = 5           # paper §5.5: enforce K >= 5 for small budgets
    max_strata: int = 64
    budget_per_stratum: int = 1000  # paper: auto-K so each stratum gets >= 1000
    weight_exponent: float = 1.0  # Fig. 13b: sampling weight = sim ** exponent
    weight_floor: float = 1e-3    # defensive-mixture floor: keeps every tuple
                                  # reachable at feasible budgets (a 1e-6 floor
                                  # is "unbiased" but its HT tail is unsampleable,
                                  # silently reintroducing the FN bias of blocking)
    n_bootstrap: int = 1000       # paper: 1000 resamples
    exact_beta_max_k: int = 16    # exhaustive subset search limit for beta*
    avg_bias_correction: bool = True  # Eq. (3) Taylor correction
    max_dense_weight_bytes: int = 256 * 2**20
                                  # engine dispatch threshold: the dense BAS
                                  # path materialises an (N1*...*Nk,) float64
                                  # chain-weight array; when that footprint
                                  # exceeds this cap, run_auto routes to the
                                  # streaming path (O(N + alpha*b) memory)
    use_kernel: bool = True       # streaming stratification: use the fused
                                  # similarity kernels (on a CUDA device they
                                  # launch or raise; False is the explicit
                                  # blocked-host configuration)
    use_sweep: bool = True        # fuse the stratification passes into ONE
                                  # sim_sweep kernel launch (histogram +
                                  # top-k + per-block count tiles); False
                                  # keeps the two-pass sim_hist + sim_topk
                                  # schedule (bit-identical at fp32)
    sweep_precision: str = "fp32"  # opt-in low-precision sweep: "bf16"
                                  # (bf16-rounded inputs, f32 accumulation) or
                                  # "int8" (per-row-quantised embeddings,
                                  # int32 accumulation); only the strata
                                  # boundaries move — HT estimates stay
                                  # unbiased (membership is deterministic)
    sweep_tolerance: Optional[float] = None
                                  # max CDF shift tolerated from a
                                  # low-precision sweep before it falls back
                                  # to fp32; None uses the documented
                                  # per-precision default from
                                  # configs.joinml_embedder.EMBEDDING_PRECISIONS
    defensive_mix: float = 0.2    # within-stratum sampling = (1-mix)*importance
                                  # + mix*uniform (Hesterberg defensive IS):
                                  # caps HT weights at |D_i|/mix, bounding the
                                  # variance blow-up when false negatives hide
                                  # at near-floor similarity (beyond-paper)
    cascade: bool = False         # multi-fidelity cascade (core/cascade.py):
                                  # a cheap proxy oracle labels broadly, the
                                  # expensive Oracle pays only for the
                                  # difference-estimator correction; run_auto
                                  # routes through it for linear aggregates
                                  # when a proxy is available
    cascade_proxy_factor: float = 4.0
                                  # proxy-stage sample rows per unit of
                                  # (expensive) oracle budget: the proxy term
                                  # is HT-estimated from factor*b cheap draws
    cascade_proxy_threshold: float = 0.5
                                  # default similarity-proxy decision
                                  # threshold on the chain weight (used when
                                  # no explicit proxy oracle is supplied)


@dataclasses.dataclass
class JoinSpec:
    """A chain join over ``k`` tables.

    embeddings: per-table (N_i, d) unit-normalised float arrays.  Consecutive
    tables must share embedding dimensionality (chain-join semantics).
    """

    embeddings: Sequence[np.ndarray]

    def __post_init__(self):
        assert len(self.embeddings) >= 2, "need at least two tables"

    @property
    def k(self) -> int:
        return len(self.embeddings)

    @property
    def sizes(self) -> tuple:
        return tuple(int(e.shape[0]) for e in self.embeddings)

    @property
    def n_tuples(self) -> int:
        out = 1
        for n in self.sizes:
            out *= n
        return out


# g(.) — attribute to aggregate over; receives (n, k) int32 tuple indices.
AttrFn = Callable[[np.ndarray], np.ndarray]


def constant_attr(value: float = 1.0) -> AttrFn:
    def g(idx: np.ndarray) -> np.ndarray:
        return np.full((idx.shape[0],), value, dtype=np.float64)

    return g


@dataclasses.dataclass
class Query:
    spec: JoinSpec
    agg: Agg
    oracle: "Oracle"                     # noqa: F821 (core.oracle)
    g: Optional[AttrFn] = None           # defaults to COUNT semantics
    budget: int = 10000
    confidence: float = 0.95
    group_fn: Optional[AttrFn] = None    # GroupBy: maps tuples -> int group id
    n_groups: int = 0
    g_bounds: Optional[tuple] = None     # (lo, hi) data-wide bounds of g, used
                                         # for MIN/MAX CIs (paper §5.3)
    proxy: Optional["Oracle"] = None     # noqa: F821 — cheap proxy oracle for
                                         # the multi-fidelity cascade
                                         # (core/cascade.py); its calls are
                                         # NOT charged against ``budget``

    def attr(self) -> AttrFn:
        return self.g if self.g is not None else constant_attr(1.0)
