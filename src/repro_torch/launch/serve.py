"""Serving launcher: continuous-batching decode or batched pair scoring (the
Oracle endpoint) for a given --arch, and the index maintenance modes, on
the card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --mode decode --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch joinml-oracle \\
        --mode score --pairs 64
    ... --device cpu        # the plain PyTorch versions of the kernels

As in the reference launcher, the model is the architecture's reduced config
(``get_smoke_config``) with the byte tokenizer's vocabulary and random
weights (seed 0).  Decode takes every ``--arch``: it admits requests
mid-flight where the cache is positional and in waves for the recurrent
families.  Score takes every ``--arch`` but an encoder-decoder
(``whisper-medium``): a pair is text only, so there are no frames to score
it against, and the reference's score mode is not defined for it either.

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

The reference's serving-plane modes (``service``, ``server``, ``client``
and ``worker``) need parts of the port that are not there yet and raise
``NotImplementedError`` (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

NOT_PORTED = {"service": "9", "server": "9", "client": "9", "worker": "9"}
INDEX_MODES = ("build-index", "refresh-index")


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


def _make_scorer(cfg, params, tok, records, batch_size: int, device):
    from ..data.pipeline import pair_example
    from ..serve import PairScorer

    def tok_pair(pair):
        t, _ = pair_example(tok, records[pair[0]], records[pair[1]], None, 48)
        return t[t != tok.PAD]

    return PairScorer(cfg, params, tok_pair, tok.YES, tok.NO, max_len=48,
                      batch_size=batch_size, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="any architecture of repro_torch.configs; --mode score "
                         "is not defined for an encoder-decoder (whisper-medium): "
                         "a pair is text only and has no frames")
    ap.add_argument("--mode", choices=("decode", "score", *INDEX_MODES,
                                       *NOT_PORTED),
                    default="decode")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--n-side", type=int, default=48,
                    help="index modes: synthetic table side length")
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
    if args.mode in NOT_PORTED:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet (ROADMAP queue 1, item "
            f"{NOT_PORTED[args.mode]})")
    if args.mode == "build-index":
        _run_build_index(args)
        return
    if args.mode == "refresh-index":
        _run_refresh_index(args)
        return

    from ..configs import get_smoke_config
    from ..data.pipeline import ByteTokenizer
    from ..models import init_params
    from ..serve import ContinuousBatcher, Request

    tok = ByteTokenizer()
    cfg = get_smoke_config(args.arch, vocab_size=tok.vocab_size)
    if args.mode == "score" and cfg.family == "encdec":
        ap.error(f"--mode score is not defined for {args.arch}: an "
                 "encoder-decoder needs frames, and a pair is text only")
    params = init_params(cfg, seed=0, device=args.device)
    print(f"[serve] {cfg.name} ({cfg.param_count()/1e6:.1f}M) mode={args.mode} "
          f"device={params.embed.device}")

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
    else:
        records = [f"entity {i % 16} record {i}" for i in range(64)]
        scorer = _make_scorer(cfg, params, tok, records, 16, args.device)
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
