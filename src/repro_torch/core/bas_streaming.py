"""BAS without materialising the cross product (paper §5.3, the
"cross product cannot fit into memory" regime) — k-way chain joins.

Differences from the dense path (``bas.run_bas``):

* stratification uses the histogram threshold
  (``stratify.stratify_streaming_chain``, backed by the fused single-sweep
  ``sim_sweep`` CUDA kernel on the card, its plain PyTorch version on the
  CPU, or the blocked host path at ``use_kernel=False``) — O(bins)
  memory, **one** streaming pass over prefix blocks emitting histogram +
  per-block count tiles + per-row top-k; collection reads the top-k and
  rescans only blocks the tiles flag.  The chain weight factorises as
  prefix-weight x last-edge pair weight, so the kernel's per-row ``scale``
  operand carries the prefix chain weight and nothing bigger than one block
  is materialised.  ``cfg.sweep_precision`` opts into the bf16/int8
  fast path (tolerance-gated, see ``stratify.sweep_pass``); the fp32
  default bins bit-identically to the retired two-pass schedule, and its
  fused walk statistics (row sums / chain total, compensated f32) agree
  with the f64 recomputation to ~1 ulp — so estimates match the two-pass
  path to ~1e-7 relative, with zero extra passes over the product;
* the minimum sampling regime D_0 is sampled by **walk + rejection**: WWJ
  walk proposals from the full-space distribution
  p(t) = (1/N1) * prod_j w_j(t_j, t_{j+1}) / r_j(t_j)
  are rejected if they fall in the blocking regime; accepted tuples have
  exact probability p(s) / (1 - P(top)), where P(top) = sum of full-space
  probabilities over the collected top set (computable from the streamed
  per-edge row sums) — so Horvitz-Thompson stays exact for any chain length;
* per-stratum weights are recomputed by gathering only the stratum's tuples
  (``similarity.chain_tuple_weights``, O(n * k * d)).

Estimator assembly (pilot, MSE-optimal blocking allocation, execution,
bootstrap-t CIs, and the MIN/MAX/MEDIAN extensions) is the *same code* as the
dense path: ``bas.run_stratified_pipeline`` over a ``StratifiedSpace`` whose
callbacks never touch the cross product.

Memory: O(sum_i N_i + alpha*b + b + bins) — never O(N1*...*Nk).  The engine
front-end picks this path automatically when the dense flat-weight footprint
exceeds ``BASConfig.max_dense_weight_bytes`` (see ``dispatch.run_auto``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..obs.telemetry import span, traced_query
from .bas import StratifiedSpace, StratumDraw, run_exact, run_stratified_pipeline
from .similarity import (
    aligned_pair_weights,
    chain_total_weight,
    chain_tuple_weights,
    edge_row_sums,
    flat_to_tuples,
    tuples_to_flat,
)
from .stratify import stratify_streaming_chain
from .types import BASConfig, Query, QueryResult
from .wander import flat_sample, walk_sample


def _walk_rejection_sample(
    embeddings: list,
    sizes: tuple,
    top_set: set,
    n: int,
    cfg: BASConfig,
    rng: np.random.Generator,
    max_rounds: int = 50,
    device="cuda",
):
    """Sample n tuples from D_0 with exact probabilities: k-way WWJ walk
    proposals, rejected when they land in the blocking regime.  Returns
    ((m, k) tuples, (m,) full-space walk probabilities), m <= n."""
    k = len(embeddings)
    out_idx = np.empty((n, k), np.int64)
    out_p = np.empty(n, np.float64)
    got = 0
    for _ in range(max_rounds):
        need = n - got
        if need <= 0:
            break
        m = max(int(need * 1.3) + 16, 32)
        ws = walk_sample(embeddings, m, rng, cfg.weight_exponent, cfg.weight_floor,
                         device=device)
        flat = tuples_to_flat(ws.idx, sizes)
        keep = np.fromiter((f not in top_set for f in flat), bool, len(flat))
        take = min(int(keep.sum()), need)
        out_idx[got : got + take] = ws.idx[keep][:take]
        out_p[got : got + take] = ws.prob[keep][:take]
        got += take
    return out_idx[:got], out_p[:got]


def build_streaming_space(
    query: Query,
    cfg: BASConfig,
    rng: np.random.Generator,
    n_bins: int = 4096,
    use_kernel: Optional[bool] = None,
    use_sweep: Optional[bool] = None,
    precision: Optional[str] = None,
    artifact=None,
    index_store=None,
    device="cuda",
) -> tuple:
    """Stage 1 of the streaming path: histogram stratification + the
    walk+rejection D_0 sampler, packaged as a :class:`StratifiedSpace`.
    Returns ``(space, extra_detail)`` — the extra detail carries the
    streaming-specific keys (``p_top``, ``use_kernel``) the caller merges
    into its pipeline detail dict.  Shared by ``run_bas_streaming`` and the
    cascade estimator so both spend stage 1 identically.

    The sweep comes from ``artifact`` when one is given, else from
    ``index_store.get_or_build`` (which builds on the store's device at
    its first miss), else from a fresh pass on ``device``."""
    if use_kernel is None:
        use_kernel = cfg.use_kernel
    if use_sweep is None:
        use_sweep = cfg.use_sweep
    if precision is None:
        precision = cfg.sweep_precision

    embeddings = [np.asarray(e, np.float32) for e in query.spec.embeddings]
    sizes_spec = tuple(e.shape[0] for e in embeddings)
    exp, floor = cfg.weight_exponent, cfg.weight_floor

    # ---- streaming stratification (single fused sweep) -------------------
    with span("joinml.stratify"):
        index_hit = None
        index_build_ms = None
        if artifact is None and index_store is not None:
            # the store's resolve: a lookup on a hit, the sweep on a miss
            with span("joinml.index.build") as build:
                artifact, index_hit = index_store.get_or_build(
                    embeddings, n_bins=n_bins, exponent=exp, floor=floor,
                    precision=precision, use_kernel=use_kernel,
                )
            if not index_hit:
                index_build_ms = build.seconds * 1e3
        elif artifact is not None:
            index_hit = True
        strat = stratify_streaming_chain(
            embeddings, cfg.alpha, query.budget, cfg, n_bins=n_bins,
            use_kernel=use_kernel, use_sweep=use_sweep, precision=precision,
            artifact=artifact, device=device,
        )
        k = strat.num_strata
        sizes = strat.stratum_sizes()
        top_set = set(strat.order.tolist())
    # the opt-in low-precision sweep also hands its collected weights to the
    # samplers (HT stays exact: q is computed from the weights actually
    # sampled with); the fp32 default recomputes them in f64 so estimates
    # stay bit-identical to the two-pass schedule
    lowp = (
        strat.sweep is not None and strat.sweep.precision != "fp32"
        and strat.order_weights is not None
    )

    # ---- full-space sampling distribution pieces for D_0 rejection -------
    # Walk setup (row sums + chain total weight) consumes the statistics the
    # fused sweep emitted alongside the histogram — or, on a warm index,
    # hydrates them from the artifact — so no second pass over the cross
    # product is ever launched here.  Only the two-pass baseline
    # (use_sweep=False) and low-precision sweeps (which withhold their sums,
    # see stratify.SweepInfo) fall back to the standalone recomputation.
    with span("joinml.similarity"):
        with span("joinml.walk_setup"):
            fused = strat.sweep is not None and strat.sweep.row_sums is not None
            if fused:
                row_sums = strat.sweep.row_sums
                total_weight = strat.sweep.total_weight
            else:
                row_sums = edge_row_sums(embeddings, exp, floor, device=device)
                total_weight = chain_total_weight(embeddings, exp, floor,
                                                  device=device)
        tup_top = flat_to_tuples(strat.order, sizes_spec)
        # one pass over the edges gives both the top-set chain weights and the
        # full-space walk probabilities p(t) = (1/N1) prod_j w_j / r_j
        top_w = np.ones(len(tup_top), np.float64)
        p = np.full(len(tup_top), 1.0 / sizes_spec[0], np.float64)
        for j in range(len(embeddings) - 1):
            w_j = aligned_pair_weights(
                embeddings[j], embeddings[j + 1], tup_top[:, j], tup_top[:, j + 1],
                exp, floor,
            )
            top_w *= w_j
            p *= w_j / row_sums[j][tup_top[:, j]]
        p_top = float(p.sum())

        per_tup = [None] + [
            flat_to_tuples(strat.stratum_indices(i), sizes_spec)
            for i in range(1, k + 1)
        ]
        if lowp:
            per_w = [None] + [strat.stratum_weights(i) for i in range(1, k + 1)]
        else:
            per_w = [None] + [
                chain_tuple_weights(embeddings, t, exp, floor) for t in per_tup[1:]
            ]
        weight_sums = np.zeros(k + 1, np.float64)
        weight_sums[0] = max(total_weight - float(top_w.sum()), 0.0)
        for i in range(1, k + 1):
            weight_sums[i] = float(per_w[i].sum())

    def sample_stratum(i: int, n: int) -> StratumDraw:
        if i == 0:
            tup, pw = _walk_rejection_sample(
                embeddings, sizes_spec, top_set, n, cfg, rng, device=device
            )
            q = pw / max(1.0 - p_top, 1e-12)  # exact prob within D_0
        else:
            pos, q = flat_sample(per_w[i], n, rng, cfg.defensive_mix)
            tup = per_tup[i][pos]
        return StratumDraw(tup=tup, q=q, size=int(sizes[i]))

    meta = {"path": "sweep" if strat.sweep is not None else "two-pass",
            "walk_setup": "fused" if fused else "recompute"}
    if strat.sweep is not None:
        meta.update(
            kernel=strat.sweep.kernel, precision=strat.sweep.precision,
            **strat.sweep.stats,
        )
    if artifact is not None:
        meta["path"] = "index"
        meta["index_hit"] = bool(index_hit)
        meta["index_version"] = artifact.version
        meta["delta_blocks"] = int(artifact.stats.get("delta_blocks", 0))
        if index_build_ms is not None:
            meta["index_build_ms"] = round(index_build_ms, 2)
    space = StratifiedSpace(
        sizes=sizes,
        weight_sums=weight_sums,
        sample_stratum=sample_stratum,
        stratum_tuples=lambda i: per_tup[i],
        meta=meta,
    )
    return space, {"p_top": p_top, "use_kernel": use_kernel}


@traced_query
def run_bas_streaming(
    query: Query,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    n_bins: int = 4096,
    use_kernel: Optional[bool] = None,
    use_sweep: Optional[bool] = None,
    precision: Optional[str] = None,
    artifact=None,
    index_store=None,
    device="cuda",
) -> QueryResult:
    """k-way streaming BAS.  Same estimator/CI machinery as the dense path
    (all aggregates); the cross product is never materialised.  The
    similarity passes run on ``device`` (the CUDA kernels by default).

    ``artifact`` (:class:`repro_torch.core.index.IndexArtifact`) hydrates a
    stored sweep instead of computing one; ``index_store``
    (:class:`repro_torch.core.index.IndexStore`) resolves one, building it
    at the first miss.  Either way ``detail["stratify"]`` records
    ``index_hit``, ``index_version``, ``delta_blocks`` (and
    ``index_build_ms`` when this query built it)."""
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)

    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if query.budget >= query.spec.n_tuples:
        return run_exact(query)

    space, extra = build_streaming_space(
        query, cfg, rng, n_bins=n_bins, use_kernel=use_kernel,
        use_sweep=use_sweep, precision=precision, artifact=artifact,
        index_store=index_store, device=device,
    )
    return run_stratified_pipeline(
        query, cfg, rng, space, {"mode": "bas_streaming", **extra}, device,
    )
