"""Time the data-parallel train step (``repro_torch.train.manual_dp``) at
several world sizes in one call, one rank a card over NCCL:

    python scripts/dp_scaling.py --worlds 1 2 4                 # 4 cards
    python scripts/dp_scaling.py --worlds 1 4 --device cpu      # rehearsal

Each world runs ``chip_smoke.py`` phase 12a's ranks as processes
(``chip_smoke._dp_processes``): phase 11's model, batch and optimizer (the
published ``joinml-oracle``, 16 x 128 pair tokens split over the ranks,
AdamW at eps 1), 2 steps in each of the none and int8 all-reduces, each
rank's step ms, all-reduce ms, wire types, K5 launches and peak memory
held as 12a holds them, and rank 0's first none step against the
one-process step within the trainer's bf16 rule.  It logs a row a rank,
then one JSON line: per world and mode, the step and all-reduce ms of the
steps after the first, with the cards' names and power limits.  With
``--device cpu`` the reduced config runs over gloo.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    cards = None
    if args.device == "cuda":
        if torch.cuda.device_count() < max(args.worlds):
            sys.exit(f"needs {max(args.worlds)} CUDA cards, found {torch.cuda.device_count()}")
        from repro_torch.kernels import cuda_lib

        cuda_lib.build()  # once, before the ranks load it
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip().splitlines()
    size = chip_smoke.TRAIN_FULL if args.device == "cuda" else chip_smoke.TRAIN_REHEARSAL
    backend = "nccl" if args.device == "cuda" else "gloo"
    out = {"backend": backend, "cards": cards, "worlds": {}}
    for world in args.worlds:
        rows = chip_smoke._dp_processes(size, args.device, world, None, backend=backend)
        for row in rows:
            chip_smoke.log(json.dumps({"path": "data-parallel training", **row}))
            chip_smoke._check_dp_row(row, args.device)
        vs = next(r for r in rows if r["rank"] == 0)["vs_one_process"]
        if max(vs.values()) > 1.0:
            chip_smoke.fail(f"world {world}: the first none step differs from the "
                            f"one-process step: {vs}")
        out["worlds"][world] = {
            mode: {key: [st[key] for r in rows for st in r["steps"][mode][1:]]
                   for key in ("step_ms", "all_reduce_ms")}
            for mode in chip_smoke.DP_MODES}
        out["worlds"][world]["vs_one_process"] = vs
        out["worlds"][world]["max_memory_allocated_bytes"] = max(
            r.get("max_memory_allocated_bytes") or 0 for r in rows)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
