"""Time ``chip_smoke.py`` phase 11's train step with the ``repro_torch`` of
one source tree, so that two trees compare in one call (run them in turns:
A, B, B, A):

    python scripts/compare_train_step.py --src src
    python scripts/compare_train_step.py --src build/parent/src

``--src`` is the ``src`` directory of the tree that trains (another commit
unpacked with ``git archive`` under ``build/``); its kernels build into that
tree's own ``build/``.  The step, its data, its timing and its checks are
phase 11's (``chip_smoke._train_run`` at ``TRAIN_FULL``: the published
``joinml-oracle``, 12 steps on one repeated batch of 16 x 128 pair tokens,
the median of steps 3-12), which logs its row.  Then one JSON line: the
tree, the median step ms, the peak of ``max_memory_allocated``, the idle
share over 3 profiled steps, and the card's name and power limit.  Needs a
CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    src = os.path.abspath(args.src)
    sys.path.insert(0, src)  # ahead of chip_smoke's own src
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    row = chip_smoke._train_run("11: training", chip_smoke.TRAIN_FULL, "cuda")[0]
    import repro_torch

    if not repro_torch.__file__.startswith(src + os.sep):
        sys.exit(f"trained with {repro_torch.__file__}, not the tree under {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "median_step_ms": row["median_step_ms"],
                      "max_memory_allocated_bytes": row["max_memory_allocated_bytes"],
                      "idle_share": row["idle_share"], "card": smi}), flush=True)


if __name__ == "__main__":
    main()
