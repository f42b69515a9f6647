"""The readings the limits of ``correct`` are set from, for many seeds in one
process (the benchmark's own runs never run this).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 --queries 2 [--control]

For each seed: the cell's set-up and a short window of ``--queries``
queries on the timed path, then the numbers the run compares (the system's
readings) and, with ``--control``, the same numbers for the control in the
system's place: the plain sweep with TF32 inputs and, for a model Oracle,
the fp8 forward.  One JSON line a seed on standard output.
"""
import argparse
import gc
import json
import sys
import time

import numpy as np

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--queries", type=int, default=2)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rehearse-cpu", action="store_true")
    args = p.parse_args(argv)
    run._caches()
    sys.path[:0] = [str(run.HERE), str(run.REPO / "src")]
    import torch

    from harness.session import Session
    from harness.spec import load_cell

    cell = load_cell(args.workload, rehearse=args.rehearse_cpu)
    device = "cpu" if args.rehearse_cpu else "cuda"
    for seed in args.seeds:
        t0 = time.perf_counter()
        s = Session(cell, seed, device)
        s.setup()
        setup = time.perf_counter() - t0
        win = s.window(n_queries=args.queries)
        row = {"workload": cell.name, "seed": seed, "setup_s": setup,
               "latency_s": [r.latency_s for r in win.records],
               "ok": [r.ok for r in win.records]}
        s.engine = None
        row["program"] = s.checks(win)
        if args.control:
            row["control"] = s.control(win)
        row["check_s"] = time.perf_counter() - t0 - setup - win.window_s
        last = getattr(s.oracle, "_last", None)
        if last is not None:
            lo = np.log(last[1]) - np.log1p(-last[1])
            row["reference_log_odds"] = {
                q: float(np.quantile(lo, float(q))) for q in ("0", "0.25", "0.5", "0.75", "1")}
        for side, gaps in getattr(s.oracle, "gaps", {}).items():
            row[f"{side}_gap_quantiles"] = {
                q: float(np.quantile(gaps, float(q))) for q in ("0.5", "0.75", "0.9", "1")}
            row[f"{side}_share_above"] = {
                t: float(np.mean(gaps > float(t))) for t in ("0.125", "0.25", "0.5", "1")}
        s.close()
        del s, win
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
