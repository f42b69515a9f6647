"""The sharded train step (``train.make_train_step`` on parameters laid out
by ``models.partition.shard_params``: FSDP over "data", tensor and expert
parallelism over "model", the reference's 8 microbatches) on four cards,
one rank a card over NCCL:

    python scripts/sharded_step.py                  # 4 cards
    python scripts/sharded_step.py --device cpu     # rehearsal: smoke configs, gloo

On a 2 x 2 ("data", "model") mesh it trains the full 38-layer
``recurrentgemma-9b`` and the full ``olmoe-1b-7b`` (published widths,
weights from the seed, bf16, remat, phase 11's AdamW) on 16 x 128 pair
tokens, 3 steps each: every loss finite, the ranks agreeing, and step 1's
loss within the trainer's bf16 rule (6e-2) of ``loss_fn`` of the whole
model on rank 0's card, forward only, over the same blocks of rows (the
same MoE groups).  Then ``chip_smoke.py`` phase 14's ``joinml-oracle`` job
(f32) on the 4 x 1, 1 x 4 and 2 x 2 meshes, each world's first step held
against the one-process step on card 0, at 32 x 128 (8 microbatches over
the 4 x 1 mesh's 4 batch shards).  Each rank's step ms, collective
ms, launches and peak memory are logged (``chip_smoke.py`` phase 14's
rows and checks), then one JSON line of the held ratios, with the cards'
names and power limits.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BIG = [{"name": name, "over": {}, "batch": 16, "steps": 3, "opt": "phase11",
        "compare": "forward_loss", "mesh": (2, 2)}
       for name in ("recurrentgemma-9b", "olmoe-1b-7b")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    cards = None
    if args.device == "cuda":
        if torch.cuda.device_count() < 4:
            sys.exit(f"needs 4 CUDA cards, found {torch.cuda.device_count()}")
        from repro_torch.kernels import cuda_lib

        cuda_lib.build()  # once, before the ranks load it
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip().splitlines()
    size = chip_smoke.TRAIN_FULL if args.device == "cuda" else chip_smoke.TRAIN_REHEARSAL
    backend = "nccl" if args.device == "cuda" else "gloo"
    # 32 rows: 8 microbatches over the 4 x 1 mesh's 4 batch shards
    oracle = [dict(chip_smoke.SHARDED_ORACLE, batch=32, mesh=m)
              for m in ((4, 1), (1, 4), (2, 2))]
    out_dir = os.path.join(HERE, "build", "sharded_step")
    rows = chip_smoke.sharded_processes(size, args.device, 4, BIG + oracle, out_dir,
                                        backend=backend)
    one = chip_smoke.one_process_first_step(size, args.device, oracle[0])
    for r in rows:
        chip_smoke.log(json.dumps(r))
    held = chip_smoke.check_sharded_rows(rows, args.device, {32: one})
    by_job = {}
    for r in rows:
        job = by_job.setdefault(r["job"], {"losses": [st["loss"] for st in r["steps"]],
                                           "step_ms": {}, "collective_ms": {},
                                           "max_memory_allocated_bytes": {}})
        job["step_ms"][r["rank"]] = [st["step_ms"] for st in r["steps"]]
        job["collective_ms"][r["rank"]] = [st["collective_ms"] for st in r["steps"]]
        job["max_memory_allocated_bytes"][r["rank"]] = r.get("max_memory_allocated_bytes")
        if "one_card_loss" in r:
            job["one_card_loss"] = r["one_card_loss"]
    print(json.dumps({"backend": backend, "cards": cards, "held_ratios": held,
                      "jobs": by_job}), flush=True)


if __name__ == "__main__":
    main()
