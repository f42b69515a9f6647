"""Multi-fidelity oracle cascade with a guarantee-preserving correction.

The paper splits the cross product into regimes by embedding failure mode
and spends the Oracle budget where it matters; this module lifts that move
one level up the model stack.  A cheap *proxy* oracle (a thresholded
similarity score, a small distilled scorer, or the bf16/int8 fast path of
the served model) labels broadly, and the expensive Oracle pays only for a
difference-estimator correction — the two-regime tradition of "Joins on
Samples" composed with BAS stratification:

    AGG-hat = blocked + sum_i [ mean(g * p / q)        (proxy regime)
                              + mean(g * (o - p) / q) ] (correction regime)

Per sampled stratum, two *independent* within-stratum samples are drawn
from the same exact distribution ``q``:

* the **proxy sample** (``cascade_proxy_factor * b`` cheap rows, split
  ∝ weight mass): every row labelled only by the proxy, giving a
  low-variance HT estimate of the proxy total;
* the **correction sample** (the expensive budget ``b``): every row
  labelled by *both* oracles, HT-estimating the proxy's total signed error
  ``sum g * (o - p)``.

Each is an unbiased HT estimator of its regime's total, so their sum is
unbiased for the stratum total regardless of proxy quality — a perfect
proxy drives the correction terms (and their variance) to zero, a garbage
proxy degrades to plain-BAS-order variance, never to bias.  Both samples
are plain :class:`~repro_torch.core.estimators.StratumSample` objects (the
correction sample simply carries ``o - p`` in the label slot), so the
variance formula and CI assembly are *exactly* the existing machinery:
``combined_sum``/``combined_count``/``combined_avg`` over the
pseudo-stratum list and within-stratum bootstrap-t resampling
(``bootstrap.bootstrap_t_ci``).  Guarantees are preserved by construction.

Budget semantics: the §2 contract ("the Oracle is executed on at most ``b``
tuples") binds the *expensive* oracle only — its ledger paces pilot,
blocking, and correction rounds exactly like plain BAS.  The proxy runs on
its own unmetered ledger (``QueryResult.detail["cascade"]`` reports both).

Pipeline (mirrors ``bas.run_stratified_pipeline`` stage for stage):

1. *Stratify*: the dense or streaming stage-1 space — shared code
   (``bas.build_dense_space`` / ``bas_streaming.build_streaming_space``).
2. *Pilot* (expensive budget ``b1``): sample every stratum ∝ weight, label
   with both oracles, estimate the per-stratum variance of the linearised
   *correction* terms (the disagreement signal).
3. *Allocate*: ``allocate.argmin_beta`` on the correction variances — the
   expensive oracle blocks the strata where the proxy is untrustworthy and
   cheap sampling cannot fix it.
4. *Execute*: blocked strata are oracle-labelled exhaustively; sampled
   strata get the proxy sample plus correction top-up rounds whose
   per-stratum split follows a defensive Neyman rule on the pilot
   disagreement variances (the "spend the oracle where the correction
   needs it" step).
5. *Estimate + CI*: bootstrap-t over the proxy + correction pseudo-strata.

Serving: the proxy is a distinct :class:`~repro_torch.core.oracle.Oracle`
instance, so its :meth:`~repro_torch.core.oracle.Oracle.service_group` key
never collides with the expensive oracle's.  Through an
:class:`~repro_torch.serve.oracle_service.OracleService` the two stages
therefore coalesce into *separate* super-batches, and the proxy is attached
under its own ``cascade-proxy`` query class.  A proxy built by
:func:`similarity_proxy` carries a content fingerprint of its tables as
``name`` (the reference's recipe, so both packages name the same tables
alike): its service group, under which concurrent queries on the same
tables fuse their proxy traffic and share stored proxy labels.

Every entry point takes ``device=`` (default ``"cuda"``; raises without a
card): both stage-1 spaces run their similarity passes and kernels there.
Sampling, labelling and the estimate stay in numpy, in the reference's
order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..obs.telemetry import span, traced_query
from . import allocate as alloc_mod
from .bas import (
    StratifiedSpace,
    StratumDraw,
    _linearised_variance,
    build_dense_space,
    run_bas,
    run_exact,
)
from .bootstrap import bootstrap_t_ci
from .estimators import BlockedRegime, StratumSample, combined_count, combined_sum
from .oracle import FnOracle, Oracle, OracleBatch
from .similarity import chain_tuple_weights
from .types import Agg, BASConfig, JoinSpec, Query, QueryResult


class SimilarityProxyOracle(FnOracle):
    """The embedding proxy as an Oracle: label = chain weight >= threshold.

    ``name`` pins a *stable* service group (``("scorer", "sim-proxy:<fp>",
    threshold)``): proxies for the same tables fuse into one super-batch per
    service window and may share label-store segments — safe because the
    fingerprint binds the name to the embedding content."""

    def __init__(self, fn, threshold: float, name: Optional[str] = None):
        super().__init__(fn)
        self.threshold = float(threshold)
        self.name = name

    def service_group(self):
        if self.name is not None:
            return ("scorer", f"sim-proxy:{self.name}", self.threshold)
        return super().service_group()


def similarity_proxy(
    spec: JoinSpec,
    cfg: Optional[BASConfig] = None,
    threshold: Optional[float] = None,
) -> SimilarityProxyOracle:
    """The zero-extra-model proxy: thresholded chain similarity weight.

    This is the paper's cheap signal reused as a labelling stage — the same
    ``w = max(clip(cos, 0, 1), floor) ** exponent`` weights that drive
    sampling, thresholded into a {0,1} proxy label.  O(n * k * d) per batch,
    no model call."""
    cfg = cfg or BASConfig()
    tau = cfg.cascade_proxy_threshold if threshold is None else float(threshold)
    embeddings = [np.asarray(e, np.float32) for e in spec.embeddings]
    exp, floor = cfg.weight_exponent, cfg.weight_floor

    def fn(idx: np.ndarray) -> np.ndarray:
        w = chain_tuple_weights(embeddings, idx, exp, floor)
        return (w >= tau ** (len(embeddings) - 1)).astype(np.float64)

    import hashlib

    h = hashlib.sha256()
    for e in embeddings:
        h.update(str(e.shape).encode())
        h.update(np.ascontiguousarray(e[:: max(len(e) // 8, 1)]).tobytes())
    return SimilarityProxyOracle(fn, tau, name=h.hexdigest()[:16])


def _label_both(query: Query, proxy: Oracle, draws: list) -> tuple:
    """Label one stage's draws with BOTH oracles: one coalesced batch per
    fidelity, submit-then-await, with the cheap g(.) evaluation after both
    submits.

    Returns ``(corr_samples, o_list, p_list)`` where ``corr_samples[i]`` is
    the correction pseudo-sample (label slot = ``o - p``)."""
    ob, pb = OracleBatch(query.oracle), OracleBatch(proxy)
    oh = [None if d is None else ob.submit(d.tup) for d in draws]
    ph = [None if d is None else pb.submit(d.tup) for d in draws]
    fo, fp = ob.flush_async(), pb.flush_async()
    g = query.attr()
    gs = [None if d is None else g(d.tup) for d in draws]
    fo.result()
    fp.result()
    corr, o_list, p_list = [], [], []
    for d, ho, hp, gv in zip(draws, oh, ph, gs):
        if d is None:
            corr.append(None)
            o_list.append(None)
            p_list.append(None)
            continue
        o, p = ho.labels, hp.labels
        corr.append(StratumSample(o=o - p, g=gv, q=d.q, size=d.size))
        o_list.append(o)
        p_list.append(p)
    return corr, o_list, p_list


def _label_proxy(proxy: Oracle, query: Query, draws: list) -> list:
    """Proxy-only labelling of one stage's draws (one coalesced batch)."""
    batch = OracleBatch(proxy)
    handles = [None if d is None else batch.submit(d.tup) for d in draws]
    fut = batch.flush_async()
    g = query.attr()
    gs = [None if d is None else g(d.tup) for d in draws]
    fut.result()
    return [
        None if d is None else StratumSample(o=h.labels, g=gv, q=d.q, size=d.size)
        for d, h, gv in zip(draws, handles, gs)
    ]


def _split_budget(total: int, shares: np.ndarray, floor_n: int = 1) -> np.ndarray:
    """Split ``total`` rows ∝ shares with a per-stratum floor, trimmed so the
    split never exceeds the total (same discipline as the pilot split in
    ``run_stratified_pipeline``)."""
    n = np.maximum((shares * total).astype(np.int64), floor_n)
    while n.sum() > total and n.max() > floor_n:
        n[np.argmax(n)] -= 1
    return n


def run_cascade_pipeline(
    query: Query,
    proxy: Oracle,
    cfg: BASConfig,
    rng: np.random.Generator,
    space: StratifiedSpace,
    detail: dict,
    device="cuda",
) -> QueryResult:
    """Stages 2-5 of the cascade on an abstract stratified space (dense and
    streaming regimes share this code exactly like plain BAS shares
    ``run_stratified_pipeline``); the bootstrap-t runs on ``device``."""
    sizes, weight_sums = space.sizes, space.weight_sums
    k = len(sizes) - 1
    b = query.budget
    b1 = max(int(round(cfg.pilot_fraction * b)), 8)

    # ---- stage 1: pilot (both fidelities on the same draws) ---------------
    with span("joinml.pilot"):
        shares = weight_sums / max(weight_sums.sum(), 1e-300)
        n_pilot = _split_budget(b1, shares, floor_n=2)
        pilot_draws: list[Optional[StratumDraw]] = [None] * (k + 1)
        for i in range(k + 1):
            if sizes[i] > 0:
                pilot_draws[i] = space.sample_stratum(i, int(n_pilot[i]))
        corr, o_list, p_list = _label_both(query, proxy, pilot_draws)

        # linearisation constants (AVG influence function) from the pilot's
        # expensive labels; the pilot's proxy labels feed the disagreement stats
        pilot_plain = [
            StratumSample(o=o, g=corr[i].g, q=corr[i].q, size=corr[i].size)
            for i, o in enumerate(o_list) if o is not None
        ]
        zero = BlockedRegime(np.zeros(0), np.zeros(0))
        c_hat, _ = combined_count(pilot_plain, zero)
        s_hat, _ = combined_sum(pilot_plain, zero)
        ratio = s_hat / c_hat if c_hat > 0 else 0.0
        sigma2 = np.zeros(k + 1, np.float64)
        for i in range(k + 1):
            if corr[i] is not None:
                sigma2[i] = _linearised_variance(corr[i], query.agg, ratio, c_hat)
        n_dis = sum(len(o) for o in o_list if o is not None)
        disagree = sum(
            float(np.abs(o - p).sum())
            for o, p in zip(o_list, p_list) if o is not None
        ) / max(n_dis, 1)

    # ---- allocation on the correction variances ---------------------------
    with span("joinml.allocate"):
        b2_eff = b - query.oracle.calls
        allocation = alloc_mod.argmin_beta(
            sigma2, weight_sums, sizes, b2_eff, cfg.exact_beta_max_k
        )
        beta = set(int(i) for i in allocation.beta)

    # ---- stage 2: blocking + proxy sample + correction rounds -------------
    with span("joinml.execute"):
        block_batch = OracleBatch(query.oracle)
        beta_tuples = [(i, space.stratum_tuples(i)) for i in sorted(beta)]
        beta_handles = [block_batch.submit(tup) for _, tup in beta_tuples]
        block_fut = block_batch.flush_async()
        g_fn = query.attr()
        blocked_g = [g_fn(tup) for _, tup in beta_tuples]
        block_fut.result()
        blocked = BlockedRegime(
            o=np.concatenate([h.labels for h in beta_handles])
            if beta_handles else np.zeros(0),
            g=np.concatenate(blocked_g) if blocked_g else np.zeros(0),
        )

        sampled_ids = [i for i in range(k + 1) if i not in beta and sizes[i] > 0]
        w_s = np.array([weight_sums[i] for i in sampled_ids])
        w_share = w_s / max(w_s.sum(), 1e-300)

        # proxy regime: a large cheap sample, split ∝ weight mass (disjoint from
        # the correction sample — the two pseudo-strata must stay independent)
        proxy_samples: list[Optional[StratumSample]] = [None] * (k + 1)
        n_proxy_total = int(cfg.cascade_proxy_factor * b)
        if sampled_ids and n_proxy_total > 0:
            n_proxy = _split_budget(n_proxy_total, w_share, floor_n=2)
            proxy_draws: list[Optional[StratumDraw]] = [None] * (k + 1)
            for j, i in enumerate(sampled_ids):
                proxy_draws[i] = space.sample_stratum(i, int(n_proxy[j]))
            proxy_samples = _label_proxy(proxy, query, proxy_draws)

        # correction regime: defensive Neyman split on the pilot disagreement
        # variances — n_i ∝ sqrt(sigma2_i), mixed with the weight share so a
        # stratum whose pilot saw no disagreement still gets a trickle (the
        # pilot variance estimate is noisy, not a certificate)
        root = np.array([np.sqrt(max(sigma2[i], 0.0)) for i in sampled_ids])
        if root.sum() > 0:
            c_share = 0.8 * root / root.sum() + 0.2 * w_share
        else:
            c_share = w_share
        rounds = 0
        while rounds < 4 and sampled_ids:
            remaining = b - query.oracle.calls
            if remaining < 2 * len(sampled_ids):
                break
            n_main = _split_budget(remaining, c_share, floor_n=1)
            before = query.oracle.calls
            round_draws: list[Optional[StratumDraw]] = [None] * (k + 1)
            for j, i in enumerate(sampled_ids):
                if n_main[j] > 0:
                    round_draws[i] = space.sample_stratum(i, int(n_main[j]))
            round_corr, _, _ = _label_both(query, proxy, round_draws)
            for i in sampled_ids:
                new = round_corr[i]
                if new is not None:
                    corr[i] = new if corr[i] is None else corr[i].merge(new)
            rounds += 1
            if query.oracle.calls == before:   # fully cached; budget cannot move
                break

    # ---- estimate + CI: proxy + correction pseudo-strata ------------------
    with span("joinml.ci"):
        live = [proxy_samples[i] for i in sampled_ids
                if proxy_samples[i] is not None]
        corr_live = [corr[i] for i in sampled_ids if corr[i] is not None]
        live += corr_live
        est, ci = bootstrap_t_ci(
            live, blocked, query.agg, query.confidence, cfg.n_bootstrap, rng,
            device=device,
        )

    proxy_rows = sum(
        s.n for s in (proxy_samples[i] for i in sampled_ids) if s is not None
    )
    return QueryResult(
        estimate=float(est),
        ci=ci,
        oracle_calls=query.oracle.calls,
        detail={
            **detail,
            **({"stratify": space.meta} if space.meta else {}),
            "beta": sorted(beta),
            "num_strata": k,
            "stratum_sizes": sizes.tolist(),
            "pilot_n": n_pilot.tolist(),
            "est_mse": allocation.est_mse,
            "oracle": query.oracle.stats(),
            "cascade": {
                "proxy_calls": proxy.calls,
                "proxy_requests": proxy.requests,
                "oracle_calls": query.oracle.calls,
                "proxy_rows": int(proxy_rows),
                "correction_rows": int(sum(s.n for s in corr_live)),
                "disagreement_rate": float(disagree),
                "proxy_group": repr(proxy.service_group()),
                "oracle_group": repr(query.oracle.service_group()),
            },
        },
    )


@traced_query
def run_bas_cascade(
    query: Query,
    cfg: Optional[BASConfig] = None,
    seed: int = 0,
    proxy: Optional[Oracle] = None,
    weights: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    n_bins: int = 4096,
    artifact=None,
    index_store=None,
    device="cuda",
) -> QueryResult:
    """Two-stage cascade BAS.  ``proxy`` (or ``query.proxy``) is the cheap
    oracle; defaults to the thresholded-similarity proxy.  ``path`` forces
    the stage-1 regime (``"dense"`` | ``"streaming"``); by default the same
    memory model as ``dispatch.run_auto`` decides.  Non-linear aggregates
    (MIN/MAX/MEDIAN) have no difference decomposition and fall back to plain
    BAS on the chosen path.  Stage 1 runs on ``device``; on the streaming
    regime it stratifies from ``artifact`` or through ``index_store`` (the
    persistent stratification index) when one is given."""
    resolve_device(device)
    cfg = cfg or BASConfig()
    rng = np.random.default_rng(seed)

    query.oracle.set_budget(query.budget)
    query.oracle.bind_sizes(query.spec.sizes)
    if query.budget >= query.spec.n_tuples:
        return run_exact(query)

    from .dispatch import choose_path

    if path is None:
        path = choose_path(query.spec, cfg)
    if query.agg not in (Agg.COUNT, Agg.SUM, Agg.AVG):
        if path == "dense":
            return run_bas(query, cfg, seed=seed, weights=weights,
                           device=device)
        from .bas_streaming import run_bas_streaming

        return run_bas_streaming(
            query, cfg, seed=seed, n_bins=n_bins, artifact=artifact,
            index_store=index_store, device=device,
        )

    proxy = proxy if proxy is not None else query.proxy
    if proxy is None:
        proxy = similarity_proxy(query.spec, cfg)
    proxy.set_budget(None)          # the §2 budget binds the expensive oracle
    proxy.bind_sizes(query.spec.sizes)
    # through a service, route the proxy stage too (its own group + class) so
    # proxy traffic super-batches independently and lands in the per-class
    # telemetry; a plain local oracle keeps the proxy local as well
    svc = getattr(query.oracle, "service", None)
    attached = False
    if svc is not None and getattr(proxy, "service", None) is None:
        svc.attach(proxy, query_class="cascade-proxy")
        attached = True

    try:
        if path == "dense":
            space = build_dense_space(query, cfg, rng, weights, device)
            detail = {"mode": "bas-cascade"}
        else:
            from .bas_streaming import build_streaming_space

            space, extra = build_streaming_space(
                query, cfg, rng, n_bins=n_bins, artifact=artifact,
                index_store=index_store, device=device,
            )
            detail = {"mode": "bas-cascade", **extra}
        return run_cascade_pipeline(query, proxy, cfg, rng, space, detail, device)
    finally:
        if attached:
            svc.detach(proxy)


__all__ = [
    "SimilarityProxyOracle",
    "run_bas_cascade",
    "run_cascade_pipeline",
    "similarity_proxy",
]
