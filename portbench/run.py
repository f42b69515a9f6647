"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``workloads`` in BENCHMARK.json)
names a configuration and a traffic mix; everything else is found by name
under ``portbench/`` (see ``harness/spec.py``).  A run needs the cell's
cards and fails without them.  ``--rehearse-cpu`` is the rehearsal: the
configuration's ``rehearsal`` sizes on the CPU, through the system's plain
PyTorch paths; its line names the device ``cpu`` and carries no device
metric.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), ``breakdown`` (``--trace 1``) and, last,
``checks``: every number compared with its limit.  The same numbers are
the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# what the benchmark's process may not hold once the window has closed:
# the JAX stack and the JAX package the port was made from, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = REPO / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse-cpu", action="store_true",
                   help="the configuration's rehearsal sizes on the CPU")
    return p.parse_args(argv)


class Context:
    """What a metric reader reads."""

    def __init__(self, session, window, setup_s):
        self.window, self.setup_s = window, setup_s
        self.tables, self.oracle = session.tables, session.oracle
        self.config, self.mix = session.config, session.mix
        self.service = session.service.stats() if session.service is not None else None


def judge(numbers: dict, limits: dict) -> dict:
    """name -> {value, limit} for every number the configuration limits; a
    number the run could not read has the value None, and fails."""
    return {k: {"value": None if numbers.get(k) is None else float(numbers[k]), "limit": lim}
            for k, lim in limits.items()}


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    sys.path[:0] = [str(HERE), str(REPO / "src")]
    import torch

    from harness.session import Session
    from harness.spec import load_cell

    cell = load_cell(args.workload, rehearse=args.rehearse_cpu)
    if args.rehearse_cpu:
        device = "cpu"
    elif not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    else:
        device = "cuda"

    session = Session(cell, args.seed, device)
    session.setup()
    setup_s = time.perf_counter() - T0
    win = session.window(seconds=args.seconds, trace=bool(args.trace))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    ctx = Context(session, win, setup_s)
    metrics = {}
    for m in cell.metrics_of("per_layer" if args.trace else "end_to_end"):
        if args.rehearse_cpu and m.reader.DEVICE:
            continue
        v = m.reader.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.entry["unit"]}

    # the system's state goes before the reference runs
    session.engine = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = judge(session.checks(win), cell.config["limits"])
    session.close()

    found = forbidden_modules()
    if found:
        print(f"the benchmark's process holds {found}: it may import neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3

    done = win.completed
    failed = len(win.records) - len(done)
    correct = bool(done) and failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips if device == "cuda" else 1,
           "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(win.records), "failed": failed,
            "metrics": metrics, "device": dev}
    if win.trace is not None and device == "cuda":
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.window_s
        line["breakdown"] = {"device_ops": win.trace.device_ops,
                             "idle_gaps": win.trace.idle_gaps}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
