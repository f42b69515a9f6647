"""Serving launcher: continuous-batching decode, batched pair scoring (the
Oracle endpoint), the in-process multi-query oracle service, one role of a
multi-host serving fleet, or the index maintenance modes, for a given
--arch, on the card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --mode decode --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch joinml-oracle \\
        --mode score --pairs 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch joinml-oracle \\
        --mode service --queries 4 --budget 300
    ... --device cpu        # the plain PyTorch versions of the kernels

As in the reference launcher, the model is the architecture's reduced config
(``get_smoke_config``) with the byte tokenizer's vocabulary and random
weights (seed 0); ``--full-width`` takes the published config instead.
Decode takes every ``--arch``: it admits requests mid-flight where the cache
is positional and in waves for the recurrent families.  Score, service,
server and worker take every ``--arch`` but an encoder-decoder
(``whisper-medium``): a pair is text only, so there are no frames to score
it against, and the reference's score mode is not defined for it either.

Multi-host modes (see docs/serving.md for the topology)::

    # host A: a worker (serves its scorer over TCP, no downstream)
    ... serve --mode worker --port 7432
    # host B: the front server; shards super-batches over itself + host A
    ... serve --mode server --port 7431 --worker-hosts hostA:7432
    # any host: a client process running BAS queries against the fleet
    ... serve --mode client --connect hostB:7431 --queries 4 --budget 300

``--mode service`` runs concurrent BAS queries against ONE served scorer
through an :class:`repro_torch.serve.oracle_service.OracleService`: each
query's pilot/blocking/top-up flushes coalesce across queries into
super-batches.  ``--mode server|worker`` expose exactly that machinery over
TCP (:class:`repro_torch.serve.transport.OracleServiceServer`; ``--port 0``
binds a free port, and the bound address is printed); ``--mode client``
runs the same BAS queries through
:class:`repro_torch.serve.transport.RemoteOracle` — plan/commit stay
client-side, only labelling crosses the network.  The wire protocol is the
reference's, so a client or worker of either package serves the other.
``--label-store-mb``/``--label-store-root`` give the service/server/worker
modes a shared cross-query label store (charge-once oracle caching, see
``repro_torch.serve.label_store``); shutdown prints window fill/dedup
ratios and the store hit rate from the unified ``snapshot()`` surface.
``--tracker memory|jsonl`` attaches a :mod:`repro_torch.obs` metrics tracker
(JSON-lines output via ``--tracker-out``), ``--metrics-port`` serves the
snapshot as OpenMetrics, and ``--deadline-ms`` puts the service-mode
queries under deadline-based admission control (docs/serving.md).  A server
or worker scores the pairs of ``--records`` (a JSON file
``{"left": [...], "right": [...]}`` of record strings) when given, else the
reference's synthetic records, at ``--threshold`` and in batches of
``--score-batch`` pairs.  With ``--shard`` every scorer splits its batch
dimension over the one-process host mesh of the local cards
(``launch.mesh.make_host_mesh``, ``launch.sharding.data_parallel``; with
``--device cpu`` one CPU slot).

Index maintenance modes (no model; see ``repro_torch.core.index``)::

    # one cold sweep -> content-addressed artifact under --index-root
    ... serve --mode build-index --index-root runs/index --n-side 256
    # append rows to one table, version-bumped delta maintenance
    ... serve --mode refresh-index --index-root runs/index \\
        --append-rows 32 --append-table 1

``--mode build-index`` builds a persistent stratification index (one fused
sweep) over ``--tables`` (comma-separated ``.npy`` embedding files) or the
synthetic demo pair, and saves it atomically.  ``--mode refresh-index``
loads the newest stored version and applies incremental ``append_rows``
maintenance — cost proportional to the appended rows, version bumped so
stale readers detect drift.  An :class:`repro_torch.core.index.IndexStore`
pointed at the same ``--index-root`` serves warm queries from these
artifacts.  The layout is the reference launcher's, so either package's
store reads what the other wrote.

Every mode runs on the card unless ``--device cpu`` is given, and raises
``RuntimeError`` without one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import resolve_device

INDEX_MODES = ("build-index", "refresh-index")
FLEET_MODES = ("service", "server", "client", "worker")


def _index_tables(args) -> list:
    """Embedding tables for the index modes: ``--tables a.npy,b.npy`` or the
    same seeded synthetic pair the reference launcher builds."""
    if args.tables:
        return [np.load(p.strip()) for p in args.tables.split(",")]
    from ..data import make_clustered_tables

    n = args.n_side
    ds = make_clustered_tables(n, n, n_entities=max(2 * n // 3, 4),
                               noise=0.4, seed=0)
    return [np.asarray(e, np.float32) for e in ds.spec().embeddings]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run_build_index(args) -> None:
    """``--mode build-index``: one cold sweep on ``--device`` -> saved
    artifact."""
    from ..checkpoint.index_io import save_index
    from ..core.index import build_index

    embs = _index_tables(args)
    t0 = time.time()
    art = build_index(embs, n_bins=args.bins, precision=args.precision,
                      device=args.device)
    _sync(args.device)
    path = save_index(args.index_root, art)
    print(f"[index] built key={art.key[:16]}... v{art.version} over tables "
          f"{art.sizes} in {time.time()-t0:.2f}s on {args.device} "
          f"(kernel={art.kernel}, {art.nbytes/1e6:.1f} MB) -> {path}")


def _run_refresh_index(args) -> None:
    """``--mode refresh-index``: incremental append maintenance on the
    newest stored version (delta-proportional cost, version bump), the
    delta sweeps on ``--device``."""
    from ..checkpoint.index_io import list_indexes, load_index, save_index
    from ..core.index import append_rows
    from ..core.similarity import normalize

    key = args.key
    if not key:
        stored = list_indexes(args.index_root)
        if not stored:
            raise SystemExit(f"[index] nothing stored under {args.index_root}")
        # newest lineage: append_rows re-keys (content-addressing) but keeps
        # bumping version, so the highest version is the latest refresh
        key = max(stored, key=lambda s: s["version"])["key"]
    art = load_index(args.index_root, key)
    if args.append_file:
        new_rows = np.load(args.append_file)
    else:
        rng = np.random.default_rng(art.version)
        d = art.embeddings[args.append_table].shape[1]
        new_rows = normalize(rng.standard_normal((args.append_rows, d)))
    t0 = time.time()
    art2 = append_rows(art, args.append_table, new_rows, device=args.device)
    _sync(args.device)
    path = save_index(args.index_root, art2)
    print(f"[index] refreshed key={art.key[:16]}... -> {art2.key[:16]}... "
          f"v{art.version}->v{art2.version}: +{len(new_rows)} rows on table "
          f"{args.append_table}, {art2.stats['last_delta_blocks']} delta "
          f"tile(s) in {time.time()-t0:.2f}s on {args.device} -> {path}")


def _make_scorer(cfg, params, tok, left, right, batch_size: int, device, shard=False):
    """Record-pair scorer: pair ``(i, j)`` tokenizes ``left[i]`` against
    ``right[j]``; with ``shard``, data-parallel over the host mesh."""
    from ..data.pipeline import pair_example
    from ..serve import PairScorer

    mesh = None
    if shard:
        from .mesh import make_host_mesh

        mesh = make_host_mesh(device=device)
        print(f"[serve] sharding score batches over mesh {dict(mesh.shape)}", flush=True)

    def tok_pair(pair):
        t, _ = pair_example(tok, left[pair[0]], right[pair[1]], None, 48)
        return t[t != tok.PAD]

    return PairScorer(cfg, params, tok_pair, tok.YES, tok.NO, max_len=48,
                      batch_size=batch_size, mesh=mesh, device=device)


def _fleet_records(args, n_side: int) -> tuple[list, list]:
    """The record tables a served scorer labels pairs of: ``--records`` (a
    JSON file ``{"left": [...], "right": [...]}``) or the reference's
    synthetic records, the same list on both sides."""
    if args.records:
        import json

        with open(args.records) as f:
            tables = json.load(f)
        return list(tables["left"]), list(tables["right"])
    records = [f"entity record {i:03d}" for i in range(n_side)]
    return records, records


def _run_client(args) -> None:
    """``--mode client``: BAS queries against a remote serving fleet.  Builds
    the same synthetic join the demo server scores (seeded, so every process
    agrees on table sizes), runs ``--queries`` concurrent queries through
    per-query :class:`RemoteOracle`\\ s, and prints estimates + latency.
    Planning, the weights and the estimate run here, on ``--device``."""
    from ..core import Agg, BASConfig, Query, run_bas
    from ..data import make_clustered_tables
    from ..serve.oracle_service import serve_queries
    from ..serve.transport import RemoteOracle, parse_address

    address = parse_address(args.connect)
    n = args.n_side
    ds = make_clustered_tables(n, n, n_entities=max(2 * n // 3, 4),
                               noise=0.4, seed=0)
    oracles = [RemoteOracle(address, args.group) for _ in range(args.queries)]
    queries = [Query(spec=ds.spec(), agg=Agg.COUNT, oracle=o,
                     budget=args.budget) for o in oracles]
    lat = np.zeros(args.queries)

    def job(i: int):
        t0 = time.time()
        try:
            return run_bas(queries[i], BASConfig(n_bootstrap=100), seed=i,
                           device=args.device)
        finally:
            lat[i] = time.time() - t0
            oracles[i].close()       # free the server's window bookkeeping

    t0 = time.time()
    results = serve_queries(None, [lambda i=i: job(i)
                                   for i in range(args.queries)])
    dt = time.time() - t0
    labels = sum(o.calls for o in oracles)
    reconnects = sum(o.conn.reconnects for o in oracles)
    print(f"[client] {args.queries} queries against "
          f"{address[0]}:{address[1]}, {labels} labels in {dt:.2f}s "
          f"({labels/max(dt,1e-9):.1f} labels/s, {reconnects} reconnects); "
          f"p50={np.quantile(lat, 0.5)*1e3:.0f}ms "
          f"p99={np.quantile(lat, 0.99)*1e3:.0f}ms", flush=True)
    for i, r in enumerate(results):
        print(f"[client]   q{i}: estimate={r.estimate:.1f} "
              f"ci=[{r.ci.lo:.1f}, {r.ci.hi:.1f}] calls={oracles[i].calls}",
              flush=True)


def _make_label_store(args):
    """Optional service-resident
    :class:`repro_torch.serve.label_store.LabelStore` for the
    service/server/worker modes: ``--label-store-mb 0`` (the default)
    disables it; ``--label-store-root`` additionally persists stable
    segments across restarts."""
    if not args.label_store_mb and not args.label_store_root:
        return None
    from ..serve.label_store import LabelStore

    store = LabelStore(max_bytes=int((args.label_store_mb or 256) * 2**20),
                       root=args.label_store_root or None)
    where = args.label_store_root or "memory-only"
    print(f"[serve] label store: {args.label_store_mb or 256} MB budget, "
          f"root={where}, {store.loads} segment(s) hydrated", flush=True)
    return store


def _make_tracker(args):
    """Tracker for the service/server/worker modes: ``--tracker none`` (the
    default, zero-cost hooks), ``memory`` (in-process snapshot), or ``jsonl``
    (append every signal to ``--tracker-out``)."""
    from ..obs import make_tracker

    tracker = make_tracker(args.tracker,
                           path=args.tracker_out or "tracker.jsonl")
    if args.tracker == "jsonl":
        print(f"[serve] tracker: jsonl -> {tracker.path}", flush=True)
    return tracker


def _start_metrics(args, *sources):
    """``--metrics-port N``: start the OpenMetrics ``/metrics`` endpoint
    over the given ``snapshot()`` sources (0, the default, disables it).
    Returns the running :class:`repro_torch.obs.MetricsExporter` or
    ``None``."""
    if not getattr(args, "metrics_port", 0):
        return None
    from ..obs import MetricsExporter

    exp = MetricsExporter(list(sources), host=args.host,
                          port=args.metrics_port).start()
    host, port = exp.address
    print(f"[serve] metrics: http://{host}:{port}/metrics", flush=True)
    return exp


def _print_service_stats(role: str, snap: dict) -> None:
    """Shutdown observability lines shared by the fleet and service modes —
    read exclusively from the unified ``snapshot()`` surface.  The *_recent
    ratios are last-N window means (steady state), unlike the lifetime
    ratios that average warmup in forever."""
    charges_saved = (snap.get("label_store.shared", 0.0)
                     + snap.get("label_store.hits", 0.0))
    print(f"[{role}] windows: "
          f"fill={snap.get('service.window.fill_ratio', 0.0):.2f} "
          f"(recent={snap.get('service.window.fill_ratio_recent', 0.0):.2f}) "
          f"dedup={snap.get('service.window.dedup_ratio', 0.0):.2f} "
          f"(recent={snap.get('service.window.dedup_ratio_recent', 0.0):.2f}); "
          f"store: hit_rate={snap.get('label_store.hit_rate', 0.0):.2f} "
          f"charges_saved={charges_saved:.0f}", flush=True)
    if snap.get("service.admission.rejected") or snap.get(
            "service.worker.deaths"):
        print(f"[{role}] admission: "
              f"rejected={snap.get('service.admission.rejected', 0.0):.0f} "
              f"rate={snap.get('service.rate_rows_per_s', 0.0):.0f} rows/s; "
              f"workers: deaths={snap.get('service.worker.deaths', 0.0):.0f} "
              f"rejoins={snap.get('service.worker.rejoins', 0.0):.0f}",
              flush=True)
    for line in _service_class_lines(snap):
        print(f"[{role}] {line}", flush=True)


def _service_class_lines(snap: dict) -> list[str]:
    """One line per deadline/query class seen by the service: flush-latency
    histogram percentiles (``service.class.<name>.flush_ms.*``, written by a
    tracker) and the class's own admission EWMA
    (``service.class.<name>.rate_rows_per_s``)."""
    classes: set[str] = set()
    for key in snap:
        if key.startswith("service.class."):
            rest = key[len("service.class."):]
            classes.add(rest.rsplit(".", 1)[0].split(".")[0])
    lines = []
    for qc in sorted(classes):
        prefix = f"service.class.{qc}"
        parts = [f"class {qc!r}:"]
        if f"{prefix}.flush_ms.count" in snap:
            parts.append(
                f"flushes={snap[f'{prefix}.flush_ms.count']:.0f} "
                f"p50={snap.get(f'{prefix}.flush_ms.p50', 0.0):.1f}ms "
                f"p99={snap.get(f'{prefix}.flush_ms.p99', 0.0):.1f}ms"
            )
        if f"{prefix}.rate_rows_per_s" in snap:
            parts.append(
                f"rate={snap[f'{prefix}.rate_rows_per_s']:.0f} rows/s"
            )
        if len(parts) > 1:
            lines.append(" ".join(parts))
    return lines


def _run_fleet_role(args, scorer) -> None:
    """``--mode server|worker``: expose the scorer over TCP.  A worker is a
    server with no downstream hosts; ``--worker-hosts`` turns a server into
    the fleet front that shards super-batches across hosts.  Serves for
    ``--duration`` seconds (0: until interrupted or terminated)."""
    import signal
    import threading

    from ..serve.transport import (OracleServiceServer, parse_address,
                                   scorer_group)

    role = args.mode
    tracker = _make_tracker(args)
    server = OracleServiceServer(
        {args.group: scorer_group(scorer, threshold=args.threshold)},
        host=args.host, port=args.port,
        workers=args.workers, max_wait_ms=8.0,
        label_store=_make_label_store(args),
        tracker=tracker,
    )
    host, port = server.address
    print(f"[{role}] group {args.group!r} listening on {host}:{port}",
          flush=True)
    metrics = _start_metrics(args, server.service.snapshot)
    for spec in (args.worker_hosts.split(",") if args.worker_hosts else []):
        w = server.register_worker(parse_address(spec))
        print(f"[{role}] registered worker {w.address[0]}:{w.address[1]} "
              f"groups={sorted(w.groups)}", flush=True)
    # SIGTERM ends the role like Ctrl-C: the shutdown lines still print
    # (a handler can only be set from the main thread)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        deadline = time.time() + args.duration if args.duration else None
        while deadline is None or time.time() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        snap = server.service.snapshot()
        if metrics is not None:
            metrics.stop()
        server.close()
        tracker.close()
        print(f"[{role}] shut down; {snap['service.windows']:.0f} windows, "
              f"{snap['service.rows_labelled']:.0f} rows labelled, "
              f"{snap['service.remote_shards']:.0f} remote shards; "
              f"{scorer.forward_batches} device batches", flush=True)
        _print_service_stats(role, snap)


def _run_service(args, cfg, params, tok) -> None:
    """``--mode service``: ``--queries`` concurrent BAS COUNT queries
    against ONE served scorer through an in-process ``OracleService``."""
    from ..core import Agg, BASConfig, ModelOracle, Query, run_bas
    from ..data import make_clustered_tables
    from ..serve.oracle_service import (AdmissionRejected, OracleService,
                                        serve_queries)

    n_side = 48
    ds = make_clustered_tables(n_side, n_side, n_entities=64, noise=0.4,
                               seed=0)
    left, right = _fleet_records(args, n_side)
    scorer = _make_scorer(cfg, params, tok, left, right, args.score_batch,
                          args.device, args.shard)
    cfg_bas = BASConfig(n_bootstrap=100)
    # named oracles share one LabelStore segment group (an unnamed
    # ModelOracle's group is process-local and can never be persisted)
    oracles = [ModelOracle(scorer, threshold=args.threshold, name=args.group)
               for _ in range(args.queries)]
    queries = [
        Query(spec=ds.spec(), agg=Agg.COUNT, oracle=o, budget=args.budget)
        for o in oracles
    ]
    lat = np.zeros(args.queries)
    tracker = _make_tracker(args)
    shed = [0]
    with OracleService(workers=args.workers, max_wait_ms=8.0,
                       label_store=_make_label_store(args),
                       tracker=tracker) as svc:
        metrics = _start_metrics(args, svc.snapshot)
        svc.attach(*oracles, deadline_ms=args.deadline_ms or None)

        def job(i: int):
            t0 = time.time()
            try:
                while True:
                    try:
                        return run_bas(queries[i], cfg_bas, seed=i,
                                       device=args.device)
                    except AdmissionRejected as e:
                        # typed + retryable: ledger untouched, cache kept,
                        # so re-running the (deterministic) query is safe
                        shed[0] += 1
                        time.sleep(min(e.predicted_ms, 1e3) / 1e3)
            finally:
                lat[i] = time.time() - t0
                svc.detach(oracles[i])

        t0 = time.time()
        results = serve_queries(
            svc, [lambda i=i: job(i) for i in range(args.queries)]
        )
        dt = time.time() - t0
        snap = svc.snapshot()
        if metrics is not None:
            metrics.stop()
    tracker.close()
    labels = sum(o.calls for o in oracles)
    print(f"[serve] {args.queries} concurrent queries, {labels} oracle "
          f"labels in {dt:.2f}s ({labels/max(dt,1e-9):.1f} labels/s, "
          f"{scorer.forward_batches} device batches)", flush=True)
    print(f"[serve] p50={np.quantile(lat, 0.5)*1e3:.0f}ms "
          f"p99={np.quantile(lat, 0.99)*1e3:.0f}ms per query; "
          f"service: {snap['service.windows']:.0f} windows, "
          f"{snap['service.segments_per_window']:.2f} flushes/window"
          + (f"; {shed[0]} flush(es) shed and retried" if shed[0] else ""),
          flush=True)
    _print_service_stats("serve", snap)
    for i, r in enumerate(results):
        print(f"[serve]   q{i}: estimate={r.estimate:.1f} "
              f"ci=[{r.ci.lo:.1f}, {r.ci.hi:.1f}] "
              f"calls={oracles[i].calls}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="any architecture of repro_torch.configs; the "
                         "pair-scoring modes are not defined for an "
                         "encoder-decoder (whisper-medium): a pair is text "
                         "only and has no frames")
    ap.add_argument("--mode", choices=("decode", "score", *FLEET_MODES,
                                       *INDEX_MODES),
                    default="decode")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="the architecture's published config instead of "
                         "the reduced one")
    ap.add_argument("--queries", type=int, default=4,
                    help="service/client mode: concurrent BAS queries")
    ap.add_argument("--budget", type=int, default=300,
                    help="service/client mode: oracle budget per query")
    ap.add_argument("--workers", type=int, default=1,
                    help="service/server/worker mode: scorer worker threads")
    ap.add_argument("--shard", action="store_true",
                    help="data-parallel pair scoring over the host mesh "
                         "of the local cards")
    ap.add_argument("--host", default="127.0.0.1",
                    help="server/worker mode: bind address")
    ap.add_argument("--port", type=int, default=0,
                    help="server/worker mode: bind port (0 = a free port; "
                         "the bound address is printed)")
    ap.add_argument("--connect", default="127.0.0.1:7431",
                    help="client mode: front server host:port")
    ap.add_argument("--worker-hosts", default="",
                    help="server mode: comma-separated worker host:port list")
    ap.add_argument("--group", default="default",
                    help="server/worker/client mode: wire group name")
    ap.add_argument("--records", default="",
                    help="server/worker/service mode: JSON file "
                         '{"left": [...], "right": [...]} of the record '
                         "strings pairs index (default: synthetic records)")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="server/worker/service mode: P(match) threshold")
    ap.add_argument("--score-batch", type=int, default=32,
                    help="server/worker/service mode: pairs per device batch")
    ap.add_argument("--label-store-mb", type=float, default=0.0,
                    help="service/server/worker mode: shared label store "
                         "memory budget in MB (0 = disabled)")
    ap.add_argument("--label-store-root", default="",
                    help="service/server/worker mode: persist stable label "
                         "store segments under this directory")
    ap.add_argument("--tracker", choices=("none", "memory", "jsonl"),
                    default="none",
                    help="service/server/worker mode: metrics tracker "
                         "(repro_torch.obs) — none keeps the zero-cost hooks")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="service/server/worker mode: serve the unified "
                         "snapshot as OpenMetrics on this port (0=off)")
    ap.add_argument("--tracker-out", default="",
                    help="jsonl tracker output path (default tracker.jsonl)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="service mode: declare a deadline class for the "
                         "queries — flushes are shed with AdmissionRejected "
                         "when the queue predicts a miss (0 = no deadline)")
    ap.add_argument("--n-side", type=int, default=48,
                    help="server/client and index modes: synthetic table "
                         "side length")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="server/worker mode: seconds to serve (0 = forever)")
    ap.add_argument("--index-root", default="runs/index",
                    help="build-index/refresh-index mode: artifact store dir")
    ap.add_argument("--tables", default="",
                    help="build-index mode: comma-separated .npy embedding "
                         "files (default: synthetic --n-side pair)")
    ap.add_argument("--bins", type=int, default=4096,
                    help="build-index mode: sweep histogram bins")
    ap.add_argument("--precision", default="fp32",
                    help="build-index mode: sweep precision "
                         "(fp32 | bf16 | int8)")
    ap.add_argument("--key", default="",
                    help="refresh-index mode: content key (default: newest "
                         "stored index)")
    ap.add_argument("--append-rows", type=int, default=32,
                    help="refresh-index mode: synthetic rows to append")
    ap.add_argument("--append-table", type=int, default=1, choices=(0, 1),
                    help="refresh-index mode: table receiving the rows")
    ap.add_argument("--append-file", default="",
                    help="refresh-index mode: .npy of rows to append "
                         "(overrides --append-rows)")
    args = ap.parse_args(argv)
    if args.mode in FLEET_MODES:
        resolve_device(args.device)
    if args.mode == "client":
        # the client holds no model — plan/commit are local, labelling is
        # remote — so skip scorer construction entirely
        _run_client(args)
        return
    if args.mode == "build-index":
        _run_build_index(args)
        return
    if args.mode == "refresh-index":
        _run_refresh_index(args)
        return

    from ..configs import get_config, get_smoke_config
    from ..data.pipeline import ByteTokenizer
    from ..models import init_params
    from ..serve import ContinuousBatcher, Request

    tok = ByteTokenizer()
    if args.full_width:
        cfg = get_config(args.arch)
    else:
        cfg = get_smoke_config(args.arch, vocab_size=tok.vocab_size)
    if args.mode != "decode" and cfg.family == "encdec":
        ap.error(f"--mode {args.mode} is not defined for {args.arch}: an "
                 "encoder-decoder needs frames, and a pair is text only")
    params = init_params(cfg, seed=0, device=args.device)
    print(f"[serve] {cfg.name} ({cfg.param_count()/1e6:.1f}M) mode={args.mode} "
          f"device={params.embed.device}", flush=True)

    if args.mode == "decode":
        cb = ContinuousBatcher(cfg, params, batch_size=args.batch_slots,
                               max_len=128, eos_id=tok.EOS, device=args.device)
        for i in range(args.requests):
            cb.submit(Request(
                uid=i,
                prompt=np.array([tok.BOS] + tok.encode(f"req {i}: ")[:12], np.int32),
                max_new_tokens=args.max_new,
            ))
        t0 = time.time()
        done = cb.run_until_done()
        dt = time.time() - t0
        toks = sum(len(r.out_tokens) for r in done)
        print(f"[serve] {len(done)} requests, {toks} tokens, {dt:.2f}s "
              f"({toks/max(dt,1e-9):.1f} tok/s)")
    elif args.mode in ("server", "worker"):
        left, right = _fleet_records(args, args.n_side)
        scorer = _make_scorer(cfg, params, tok, left, right,
                              args.score_batch, args.device, args.shard)
        _run_fleet_role(args, scorer)
    elif args.mode == "service":
        _run_service(args, cfg, params, tok)
    else:
        records = [f"entity {i % 16} record {i}" for i in range(64)]
        scorer = _make_scorer(cfg, params, tok, records, records, 16,
                              args.device, args.shard)
        rng = np.random.default_rng(0)
        pairs = rng.integers(0, 64, size=(args.pairs, 2))
        t0 = time.time()
        p = scorer.score(pairs)
        dt = time.time() - t0
        print(f"[serve] scored {len(pairs)} pairs in {dt:.2f}s "
              f"({len(pairs)/max(dt,1e-9):.1f} pairs/s, "
              f"{scorer.forward_batches} device batches), mean={p.mean():.3f}")


if __name__ == "__main__":
    main()
