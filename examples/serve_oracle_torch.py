"""Serve a small model with batched requests on the PyTorch + CUDA port
(the demo of ``examples/serve_oracle.py`` through ``repro_torch``):
continuous-batching decode, throughput of the batched pair-scoring (Oracle)
endpoint, the async OracleService running concurrent queries against one
shared scorer, and a loopback multi-process fleet — a TCP server (plus a
registered worker host) labelling for client processes that each run their
own BAS query.  The model and the queries run on ``--device``:

    PYTHONPATH=src python examples/serve_oracle_torch.py               # a CUDA card
    PYTHONPATH=src python examples/serve_oracle_torch.py --device cpu  # plain versions

The multi-process section spawns ``repro_torch.launch.serve --mode client``
subprocesses (on the same device) against 127.0.0.1.
"""
import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import ByteTokenizer, pair_example
from repro_torch.models import init_params
from repro_torch.serve.serve_loop import ContinuousBatcher, PairScorer, Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = args.device

    tok = ByteTokenizer()
    cfg = get_smoke_config("llama3.2-1b", vocab_size=tok.vocab_size, remat=False)
    params = init_params(cfg, 0, device=dev)

    # --- continuous batching: mixed-length generation requests -------------
    rng = np.random.default_rng(0)
    cb = ContinuousBatcher(cfg, params, batch_size=4, max_len=96, eos_id=tok.EOS, device=dev)
    n_req = 8
    for i in range(n_req):
        prompt = np.array(
            [tok.BOS] + tok.encode(f"record {i}:")[: 8 + i], np.int32
        )
        cb.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
    t0 = time.time()
    done = cb.run_until_done(max_steps=500)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"continuous batching: {len(done)}/{n_req} requests finished, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/max(dt,1e-9):.1f} tok/s on {dev}, batch=4 slots)")

    # --- batched pair scoring (the Oracle endpoint) -------------------------
    records = [f"acme corp unit {i}" for i in range(32)]

    def tok_pair(pair):
        t, _ = pair_example(tok, records[pair[0]], records[pair[1]], None, 48)
        return t[t != tok.PAD]

    scorer = PairScorer(cfg, params, tok_pair, tok.YES, tok.NO, max_len=48,
                        batch_size=16, device=dev)
    pairs = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    t0 = time.time()
    p = scorer.score(pairs)
    dt = time.time() - t0
    print(f"pair scoring: {len(pairs)} pairs in {dt:.2f}s "
          f"({len(pairs)/max(dt,1e-9):.1f} pairs/s, "
          f"{scorer.forward_batches} device batches), mean P(match)={p.mean():.3f}")

    # --- the batched Oracle layer on top of the scorer ----------------------
    # Many call sites enqueue requests; one flush dedupes across all of them,
    # charges the budget ledger once, and reaches the model as a single batch.
    from repro_torch.core import ModelOracle, OracleBatch

    oracle = ModelOracle(scorer, threshold=0.5)
    oracle.bind_sizes((32, 32))
    batch = OracleBatch(oracle)
    rng = np.random.default_rng(1)
    handles = [
        batch.submit(rng.integers(0, 32, size=(24, 2))) for _ in range(6)
    ]
    batch.flush()
    labels = np.concatenate([h.labels for h in handles])
    print(f"oracle batch: {oracle.requests} requests -> {oracle.calls} model "
          f"pairs in {oracle.batches} flush(es), dedup={oracle.dedup_ratio:.2f}, "
          f"match rate={labels.mean():.3f}")

    # --- the async oracle service: concurrent queries, one scorer -----------
    # Two BAS queries run on their own threads; their pilot/blocking/top-up
    # flushes coalesce into shared super-batches on the scorer, and each
    # query's budget ledger is still charged exactly as if it ran alone.
    from repro_torch.core import Agg, BASConfig, Query, run_bas
    from repro_torch.data import make_clustered_tables
    from repro_torch.serve.oracle_service import OracleService, serve_queries

    ds = make_clustered_tables(32, 32, n_entities=48, noise=0.4, seed=3)
    oracles = [ModelOracle(scorer, threshold=0.5) for _ in range(2)]
    queries = [
        Query(spec=ds.spec(), agg=Agg.COUNT, oracle=o, budget=200)
        for o in oracles
    ]
    t0 = time.time()
    with OracleService(max_wait_ms=8.0) as svc:
        svc.attach(*oracles)

        def job(i):
            try:
                return run_bas(queries[i], BASConfig(n_bootstrap=100), seed=i, device=dev)
            finally:
                svc.detach(oracles[i])

        results = serve_queries(svc, [lambda i=i: job(i) for i in range(2)])
        stats = svc.stats()
    dt = time.time() - t0
    total = sum(o.calls for o in oracles)
    print(f"oracle service: {len(queries)} concurrent queries, {total} labels "
          f"in {dt:.2f}s; {stats['windows']} windows at "
          f"{stats['segments_per_window']} flushes/window; estimates "
          + ", ".join(f"{r.estimate:.0f}" for r in results))

    # --- multi-host dispatch on loopback: server + worker + client procs ----
    # The same scorer now serves OTHER PROCESSES: an OracleServiceServer
    # exposes it over TCP, a second server registers as a worker host (so
    # super-batches shard across "hosts" — both on loopback here), and two
    # client processes each run a BAS query through a RemoteOracle.  Plan and
    # commit never leave the clients; only label work crosses the wire.
    from repro_torch.serve.transport import OracleServiceServer, scorer_group

    group = {"default": scorer_group(scorer, threshold=0.5)}
    with OracleServiceServer(group, max_wait_ms=8.0) as worker:
        with OracleServiceServer(group, max_wait_ms=8.0,
                                 min_shard=64) as front:
            front.register_worker(worker.address)
            host, port = front.address
            env = dict(os.environ)
            src = str(Path(__file__).resolve().parents[1] / "src")
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                   "--mode", "client", "--connect", f"{host}:{port}",
                   "--queries", "1", "--budget", "150", "--n-side", "32", "--device", dev]
            t0 = time.time()
            procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      text=True) for _ in range(2)]
            outs = [p.communicate()[0] for p in procs]
            dt = time.time() - t0
            stats = front.service.stats()
        assert all(p.returncode == 0 for p in procs), outs
        for i, out in enumerate(outs):
            for line in out.strip().splitlines():
                print(f"  proc{i} {line}")
        print(f"multi-process fleet: 2 client processes in {dt:.1f}s; front "
              f"served {stats['rows_labelled']} rows in {stats['windows']} "
              f"windows, {stats['remote_shards']} shards on the worker host")


if __name__ == "__main__":
    main()
