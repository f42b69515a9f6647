"""Memory-aware BAS engine dispatcher.

The dense path (``bas.run_bas``) materialises the flat chain-weight array —
(N1*...*Nk,) float64 — which is the fastest route while it fits in memory but
silently pays for the full cross product when it does not.  The streaming
path (``bas_streaming.run_bas_streaming``) keeps O(sum N_i + alpha*b) memory
at higher constant cost (one fused similarity pass on the device,
walk+rejection D_0 sampling).  ``run_auto`` estimates the dense footprint
from the :class:`~repro_torch.core.types.JoinSpec` alone and routes
accordingly:

    dense      iff  n_tuples * 8 bytes <= cfg.max_dense_weight_bytes
    streaming  otherwise

Both paths share the estimator assembly (``bas.run_stratified_pipeline``),
so estimates and CIs are statistically interchangeable — dispatch is purely
a resource decision.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..obs import DispatchTelemetry
from ..obs.telemetry import traced_query
from .bas import run_bas
from .bas_streaming import run_bas_streaming
from .types import Agg, BASConfig, JoinSpec, Query, QueryResult

_WEIGHT_BYTES = np.dtype(np.float64).itemsize


def dense_weight_bytes(spec: JoinSpec) -> int:
    """Bytes the dense path would allocate for the flat chain weights."""
    return spec.n_tuples * _WEIGHT_BYTES


def choose_path(spec: JoinSpec, cfg: Optional[BASConfig] = None) -> str:
    """'dense' | 'streaming' for a join spec under the configured memory cap."""
    cfg = cfg or BASConfig()
    return (
        "dense" if dense_weight_bytes(spec) <= cfg.max_dense_weight_bytes
        else "streaming"
    )


@traced_query
def run_auto(
    query: Query,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    n_bins: int = 4096,
    index_store=None,
    device="cuda",
) -> QueryResult:
    """Execute BAS on whichever path the memory model selects, on
    ``device`` (default ``"cuda"``; raises without a card).

    With an :class:`~repro_torch.core.index.IndexStore`, a *fresh* resident
    artifact for the query's tables overrides the memory model: the query
    routes through the streaming path hydrating the stored sweep
    (``path="streaming-index"``) — a lookup instead of the sweep.  A
    streaming-routed miss builds through the store (once; concurrent
    queries on the same tables share the build), so the next query hits.
    Dense-routed misses stay dense: the store only wins once an artifact
    exists (built by a prior streaming query or the ``build-index``
    launcher).

    The decision is recorded in ``result.telemetry.dispatch``.

    ``cfg.cascade`` layers the multi-fidelity cascade (``core/cascade.py``)
    on top of the same memory decision: linear aggregates route through
    ``run_bas_cascade`` on the chosen regime (``path="cascade-dense"`` /
    ``"cascade-streaming"``); non-linear aggregates have no difference
    decomposition and fall through to plain BAS.
    """
    resolve_device(device)
    cfg = cfg or BASConfig()
    footprint = dense_weight_bytes(query.spec)
    path = choose_path(query.spec, cfg)
    artifact = None
    if index_store is not None:
        embeddings = [np.asarray(e, np.float32)
                      for e in query.spec.embeddings]
        artifact = index_store.lookup(
            embeddings, n_bins=n_bins, exponent=cfg.weight_exponent,
            floor=cfg.weight_floor, precision=cfg.sweep_precision,
        )
        if artifact is not None:
            path = "streaming-index"
    # a resident artifact is handed on; without one, the store itself is,
    # so that a streaming miss builds through it
    store = index_store if artifact is None else None
    if cfg.cascade and query.agg in (Agg.COUNT, Agg.SUM, Agg.AVG):
        from .cascade import run_bas_cascade   # lazy: cascade imports us

        regime = "dense" if path == "dense" else "streaming"
        res = run_bas_cascade(
            query, cfg, seed=seed, path=regime, n_bins=n_bins,
            artifact=artifact, index_store=store, device=device,
        )
        path = f"cascade-{path}"
    elif path == "dense":
        res = run_bas(query, cfg, seed=seed, device=device)
    else:
        res = run_bas_streaming(
            query, cfg, seed=seed, n_bins=n_bins, artifact=artifact,
            index_store=store, device=device,
        )
    res.telemetry.dispatch = DispatchTelemetry(
        path=path,
        dense_weight_bytes=footprint,
        max_dense_weight_bytes=cfg.max_dense_weight_bytes,
        n_tuples=query.spec.n_tuples,
        sweep=cfg.use_sweep,
        sweep_precision=cfg.sweep_precision,
        index_store=index_store is not None,
    )
    return res
