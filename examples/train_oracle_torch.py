"""End to end on the PyTorch + CUDA port: TRAIN the Oracle, then
ANSWER a join query with it (``examples/train_oracle.py`` on ``repro_torch``).

1. Builds a synthetic entity-record corpus (noisy string variants).
2. Trains the pair-scoring Oracle LM (joinml-oracle; reduced by default,
   ``--full`` the published 12-layer, d 768 config with the byte
   tokenizer's vocabulary) with the trainer's substrate: the deterministic
   sharded loader, AdamW + schedule, microbatching, async checkpointing
   with resume, preemption handling, straggler monitoring.
3. Serves the trained model as the budgeted ModelOracle of a BaS COUNT
   query and reports estimate/CI against ground truth.

    PYTHONPATH=src python examples/train_oracle_torch.py               # a CUDA card
    PYTHONPATH=src python examples/train_oracle_torch.py --device cpu  # plain versions

Flags: ``--steps N`` (default 300), ``--batch N`` (16), ``--max-len N``
(64), ``--full``, ``--ckpt PATH`` (default: a fresh temporary directory,
removed at the end), ``--budget N`` (the query's Oracle budget, 1500),
``--device``.
"""
import argparse
import dataclasses
import shutil
import tempfile
import time

import numpy as np

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import Agg, ModelOracle, Query, run_bas
from repro_torch.core.similarity import normalize
from repro_torch.core.types import JoinSpec
from repro_torch.data.pipeline import (
    ByteTokenizer,
    ShardedLoader,
    make_entity_corpus,
    make_pair_batch,
    pair_example,
)
from repro_torch.models import init_params
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.serve import PairScorer
from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="the published oracle config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--budget", type=int, default=1500)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    tok = ByteTokenizer()
    if args.full:
        cfg = dataclasses.replace(get_config("joinml-oracle"), vocab_size=tok.vocab_size)
    else:
        cfg = get_smoke_config("joinml-oracle", vocab_size=tok.vocab_size, num_layers=4,
                               d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
                               d_ff=512)
    print(f"oracle config: {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"on {args.device}")

    records, ids = make_entity_corpus(n_entities=80, records_per_entity=4,
                                      noise=0.08, seed=0)

    def batch_fn(rng):
        b = make_pair_batch(tok, records, ids, args.batch, args.max_len, rng)
        return {"tokens": b["tokens"], "loss_mask": b["loss_mask"]}

    params = init_params(cfg, 0, device=args.device)
    opt = init_opt_state(params)
    ocfg = OptimizerConfig(peak_lr=2e-3, warmup_steps=min(20, args.steps),
                           decay_steps=args.steps)
    step_fn = make_train_step(cfg, ocfg, num_microbatches=2)

    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="oracle_ckpt_")
    ckpt = AsyncCheckpointer(ckpt_dir, keep_last=2)
    preempt = PreemptionHandler()
    preempt.install()
    stragglers = StragglerMonitor(threshold=5.0)

    restored, manifest = restore_latest(ckpt_dir, {"params": params, "opt": opt})
    start = 0
    if restored is not None:
        params, opt = restored["params"], restored["opt"]
        start = manifest["step"]
        print(f"resumed from checkpoint step {start}")

    loader = ShardedLoader(batch_fn, args.batch, num_hosts=1, host_id=0, seed=7,
                           start_step=start)
    t_start = time.time()
    try:
        for _ in range(start, args.steps):
            t0 = time.time()
            step, batch = next(loader)
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            stragglers.record(step, time.time() - t0)
            if step % 50 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss={loss:.4f}  lr={float(m['lr']):.2e}  "
                      f"gnorm={float(m['grad_norm']):.2f}")
            if step % 100 == 99 or preempt.preempted:
                ckpt.save(step + 1, {"params": params, "opt": opt})
            if preempt.preempted:
                print("preempted: checkpointed and exiting")
                ckpt.wait()
                return
        ckpt.save(args.steps, {"params": params, "opt": opt})
        ckpt.wait()
    finally:
        loader.close()
        if args.ckpt is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"trained {args.steps} steps in {time.time()-t_start:.1f}s; "
          f"stragglers flagged: {len(stragglers.reports)}")

    # ---- serve the trained model as the Oracle of a BaS query -------------
    r1, id1 = records[0::4], ids[0::4]
    r2, id2 = records[1::4], ids[1::4]
    truth = (np.array(id1)[:, None] == np.array(id2)[None, :]).astype(np.int8)

    def tok_pair(pair):
        t, _ = pair_example(tok, r1[pair[0]], r2[pair[1]], None, args.max_len)
        return t[t != tok.PAD]

    scorer = PairScorer(cfg, params, tok_pair, tok.YES, tok.NO, max_len=args.max_len,
                        batch_size=32, device=args.device)
    rng = np.random.default_rng(1)
    pos = np.argwhere(truth == 1)
    negs = np.argwhere(truth == 0)
    sample = np.concatenate([pos[:50], negs[rng.choice(len(negs), 150)]])
    labels = truth[sample[:, 0], sample[:, 1]]
    p_scores = scorer.score(sample)
    thresh = float(np.quantile(p_scores[labels == 0], 0.995))
    pred = p_scores > thresh
    prec = float(labels[pred].mean()) if pred.any() else 0.0
    rec = float(pred[labels == 1].mean())
    print(f"\ntrained-oracle on held-out pairs: precision={prec:.0%} "
          f"recall={rec:.0%} at calibrated threshold {thresh:.2f}")

    def embed(recs):
        # character 3-gram counts hashed by a fixed polynomial (stable across runs)
        out = np.zeros((len(recs), 64), np.float32)
        for i, r in enumerate(recs):
            for j in range(len(r) - 2):
                out[i, sum(ord(c) * 31**n for n, c in enumerate(r[j:j + 3])) % 64] += 1.0
        return normalize(out)

    spec = JoinSpec(embeddings=[embed(r1), embed(r2)])
    oracle = ModelOracle(scorer, threshold=thresh)
    q = Query(spec=spec, agg=Agg.COUNT, oracle=oracle, budget=args.budget, confidence=0.95)
    res = run_bas(q, seed=0, device=args.device)
    print(f"BaS with learned Oracle: COUNT ~= {res.estimate:.0f} "
          f"CI=[{res.ci.lo:.0f}, {res.ci.hi:.0f}]  ground truth={float(truth.sum()):.0f}  "
          f"oracle_calls={res.oracle_calls} (budget {args.budget} of {truth.size} pairs)")


if __name__ == "__main__":
    main()
