"""Training launcher: wires the loader, the train step, async checkpointing,
resume, preemption and the straggler monitor (the reference's
``launch/train.py``) for a given --arch, on the card by default::

    PYTHONPATH=src python -m repro_torch.launch.train --arch joinml-oracle \\
        --steps 200 --batch 16 --seq 64 [--microbatches 2] [--ckpt DIR] \\
        [--ckpt-every 100] [--grad-compression bf16] [--full-width] [--device cpu]

As in the reference launcher the model has random weights (seed 0) and the
batches are uniform random tokens (and frames or patches where the family
reads them) drawn per step from the loader's seed (13); the model is the
architecture's reduced config with the byte tokenizer's vocabulary, or the
published config with ``--full-width`` (the reference's ``--smoke-config``
is ``store_true`` with ``default=True``, so it cannot be turned off).  A
start finds the newest checkpoint under ``--ckpt`` and resumes from it:
the loader restarts at that step, so the run replays the batches an
uninterrupted one would have taken.  Every family trains on the card: K5,
K6 and K7 have backward kernels.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np


def _default_ckpt() -> str:
    return str(Path(__file__).resolve().parents[3] / "build" / "repro_torch_train_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="joinml-oracle")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=_default_ckpt(),
                    help="checkpoint directory (default: build/repro_torch_train_ckpt "
                         "in the checkout)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--full-width", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "bf16", "int8"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    import torch

    from ..checkpoint.checkpoint import AsyncCheckpointer, restore_latest
    from ..configs import get_config, get_smoke_config
    from ..data.pipeline import ByteTokenizer, ShardedLoader
    from ..device import resolve_device
    from ..models import init_params
    from ..runtime.fault_tolerance import PreemptionHandler, StragglerMonitor
    from ..train import OptimizerConfig, init_opt_state, make_train_step

    dev = resolve_device(args.device)
    tok = ByteTokenizer()
    cfg = (get_config(args.arch) if args.full_width
           else get_smoke_config(args.arch, vocab_size=tok.vocab_size))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on {where}",
          flush=True)
    params = init_params(cfg, 0, device=dev)
    opt = init_opt_state(params)
    ocfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           decay_steps=args.steps,
                           grad_compression=args.grad_compression)
    step_fn = make_train_step(cfg, ocfg, args.microbatches)

    def batch_fn(rng):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (args.batch, args.seq))}
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.num_patches:
            b["patches"] = rng.standard_normal(
                (args.batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
        return b

    restored, manifest = restore_latest(args.ckpt, {"params": params, "opt": opt})
    start = 0
    if restored is not None:
        params, opt = restored["params"], restored["opt"]
        start = int(manifest["step"])
        print(f"[train] resumed at step {start} from {args.ckpt}", flush=True)

    loader = ShardedLoader(batch_fn, args.batch, seed=13, start_step=start)
    ckpt = AsyncCheckpointer(args.ckpt, keep_last=2)
    preempt = PreemptionHandler()
    preempt.install()
    mon = StragglerMonitor()
    try:
        for _ in range(start, args.steps):
            t0 = time.perf_counter()
            step, batch = next(loader)
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])  # waits for the step
            mon.record(step, time.perf_counter() - t0)
            if not np.isfinite(loss):
                raise FloatingPointError(f"step {step}: loss {loss}")
            if step % 20 == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss={loss:.4f} lr={float(m['lr']):.2e}",
                      flush=True)
            if (step + 1) % args.ckpt_every == 0 or preempt.preempted:
                ckpt.save(step + 1, {"params": params, "opt": opt})
            if preempt.preempted:
                print("[train] preempted; checkpoint saved, exiting", flush=True)
                break
        else:
            ckpt.save(args.steps, {"params": params, "opt": opt})
        ckpt.wait()
    finally:
        loader.close()
    print(f"[train] done at step {args.steps if not preempt.preempted else step + 1}; "
          f"stragglers flagged: {len(mon.reports)}; checkpoints in "
          f"{os.path.abspath(args.ckpt)}", flush=True)


if __name__ == "__main__":
    main()
