"""Serving launcher: continuous-batching decode or batched pair scoring (the
Oracle endpoint) for a given --arch, on the card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --mode decode --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch joinml-oracle \\
        --mode score --pairs 64
    ... --device cpu        # the plain PyTorch versions of the kernels

As in the reference launcher, the model is the architecture's reduced config
(``get_smoke_config``) with the byte tokenizer's vocabulary and random
weights (seed 0).  The reference's other modes need parts of the port that
are not there yet and raise ``NotImplementedError``: ``service``,
``server``, ``client`` and ``worker`` the serving plane (ROADMAP queue 1,
item 9), ``build-index`` and ``refresh-index`` the persistent index
(item 6).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

NOT_PORTED = {
    "service": "9", "server": "9", "client": "9", "worker": "9",
    "build-index": "6", "refresh-index": "6",
}


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
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--mode", choices=("decode", "score", *NOT_PORTED),
                    default="decode")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.mode in NOT_PORTED:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet (ROADMAP queue 1, item "
            f"{NOT_PORTED[args.mode]})")

    from ..configs import get_smoke_config
    from ..data.pipeline import ByteTokenizer
    from ..models import init_params
    from ..serve import ContinuousBatcher, Request

    tok = ByteTokenizer()
    cfg = get_smoke_config(args.arch, vocab_size=tok.vocab_size)
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
