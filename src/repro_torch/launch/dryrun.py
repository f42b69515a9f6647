"""Production-mesh dry run (the reference's ``launch/dryrun.py``): trace every
(architecture x input shape) cell as one rank of the port would run it on
the 16x16 mesh and on the 2x16x16 multi-pod mesh, on meta tensors, and
record its FLOPs, bytes, collectives, memory and roofline terms against
the H100's constants (``repro_torch.roofline``).

The world is a fake process group of 256 or 512 ranks in this one process
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing), started inside :func:`run_cell` and torn down
before the other mesh; importing this module changes nothing.  A fake world
is per process: a process that holds another world cannot run a cell.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun_torch]
  python -m repro_torch.launch.dryrun --all --both-meshes [--jobs 8]

Each record keeps the reference's keys.  ``hlo_flops`` / ``hlo_bytes`` /
``collective_*`` are what the trace counted (``roofline.trace_analysis``:
a kernel launch is charged its ``roofline.kernel_work``);
``roofline_kernel_adj`` has the same terms, since the traced program is the
kernel program; ``flop_counter`` is ``torch.utils.flop_counter``'s total
over the same trace, an independent count of the aten FLOPs that cannot
see the kernels; ``memory`` and ``fits`` say whether a rank's step fits the
card (``hw.HBM_BYTES``), ``param_bytes`` the parameters whole and
``param_bytes_sharded`` what a rank holds of them in the reference's layout
(every cell's step holds just that: its parameters, and a train cell's
moments or a decode cell's cache, are sharded); ``collective_by_op`` splits ``collective_links`` by collective
(all-gather, reduce-scatter, all-reduce); ``kernels`` lists each kernel's
charged launches and work.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import time
import traceback


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for the
    block; destroyed after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process; the dry "
                           "run starts its own fake world (run it in a process of its own)")
    dist.init_process_group("fake", rank=0, world_size=size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _roofline(flops: float, byts: float, links: dict, peak: float) -> dict:
    from ..roofline import hw

    compute_s = flops / peak
    memory_s = byts / hw.HBM_BW
    collective_s = links.get("nvlink", 0.0) / hw.NVLINK_BW + links.get("net", 0.0) / hw.NET_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    return dict(compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
                dominant=dominant, bound_s=max(compute_s, memory_s, collective_s))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             save_ops: bool = False, rules_name: str = None,
             num_microbatches: int = None, cfg_overrides: dict = None,
             tag: str = "") -> dict:
    from ..configs import get_config
    from . import cells as C

    rec = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "rules": rules_name or "default", "status": "?", "tag": tag,
        "cfg_overrides": cfg_overrides or {},
        "num_microbatches": num_microbatches,
    }
    cfg = get_config(arch)
    ok, why = C.cell_supported(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, out_dir)
        return rec
    try:
        with fake_world(512 if multi_pod else 256):
            rec.update(_traced(arch, shape_name, multi_pod, out_dir, save_ops, rules_name,
                               num_microbatches, cfg_overrides))
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _save(rec, out_dir)
    return rec


def _traced(arch, shape_name, multi_pod, out_dir, save_ops, rules_name, num_microbatches,
            cfg_overrides):
    from ..roofline import hw
    from ..roofline.report import model_flops
    from . import cells as C
    from .mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    n_chips = mesh.size
    t0 = time.time()
    cell = C.build_cell(arch, shape_name, mesh, rules_override=_resolve_rules(rules_name),
                        num_microbatches=num_microbatches, cfg_overrides=cfg_overrides)
    t_build = time.time() - t0
    t0 = time.time()
    cost, memory = C.trace_cell(cell, mesh)
    t_trace = time.time() - t0
    mode = cell.trace
    memory["hbm_fraction"] = round(memory["total_bytes"] / hw.HBM_BYTES, 3)
    f32 = cell.cfg.dtype == "float32"
    peak = hw.PEAK_FLOPS_F32 if f32 else hw.PEAK_FLOPS_BF16
    roof = _roofline(cost.flops, cost.bytes, mode.links, peak)
    mf = model_flops(cell.cfg, C.SHAPES[shape_name])
    out = dict(
        status="ok",
        num_microbatches=cell.num_microbatches,
        lower_s=round(t_build, 1),
        compile_s=round(t_trace, 1),
        memory=memory,
        fits=memory["hbm_fraction"] <= 1.0,
        param_bytes=C.whole_bytes(cell.args[0]),
        param_bytes_sharded=C.param_bytes_sharded(cell, mesh),
        flop_counter=dict(flops=mode.flop_counter_flops),
        hlo_flops=cost.flops,
        hlo_bytes=cost.bytes,
        collective_bytes=cost.collective_bytes,
        collective_ops=cost.collective_ops,
        collective_links=dict(mode.links),
        collective_by_op={op: dict(links) for op, links in mode.op_links.items()},
        unresolved_whiles=cost.unresolved_whiles[:8],
        roofline=roof,
        roofline_kernel_adj={k: roof[k] for k in ("compute_s", "memory_s", "collective_s")},
        peak_flops=peak,
        kernels=mode.kernels,
        model_flops=mf,
        model_flops_per_chip=mf / n_chips,
        useful_compute_ratio=(mf / n_chips) / cost.flops if cost.flops else 0.0,
        trip_hints=cell.trip_hints,
        n_chips=n_chips,
    )
    if save_ops:
        fn = os.path.join(out_dir, f"{_slug(arch)}_{shape_name}_{_mesh_name(multi_pod)}"
                                   ".ops.tsv.gz")
        os.makedirs(out_dir, exist_ok=True)
        with gzip.open(fn, "wt") as f:
            f.write("op\tcalls\tflops\tbytes\n")
            for op, (n, fl, by) in sorted(mode.ops.items(), key=lambda kv: -kv[1][2]):
                f.write(f"{str(op)}\t{n}\t{fl:.0f}\t{by:.0f}\n")
            for k, v in mode.kernels.items():
                f.write(f"kernel:{k}\t{v['launches']}\t{v['flops']:.0f}\t{v['bytes']:.0f}\n")
    return out


def _weight(job) -> float:
    """A cell's rough tracing cost, to start the longest first: the
    parameters the optimizer walks (train) or the layers run."""
    from ..configs import get_config
    from . import cells as C

    cfg = get_config(job[0])
    return cfg.param_count() * (4 if C.SHAPES[job[1]]["kind"] == "train" else 1)


def _run_all(jobs: list, workers: int):
    """``run_cell`` of each job, in order with one worker; with more, in
    worker processes (spawned, each starting its own fake worlds), the
    costliest cells first, yielding each record as it is done."""
    if workers <= 1:
        for job in jobs:
            yield run_cell(*job)
        return
    import concurrent.futures as cf
    import multiprocessing as mp

    with cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(run_cell, *job) for job in sorted(jobs, key=_weight, reverse=True)]
        for fut in cf.as_completed(futs):
            yield fut.result()


def _mesh_name(multi_pod):
    return "2x16x16" if multi_pod else "16x16"


def _resolve_rules(name):
    if not name or name == "default":
        return None
    from . import sharding as S

    return getattr(S, name)


def _slug(arch):
    return arch.replace(".", "_").replace("/", "_")


def _save(rec, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if rec.get("rules", "default") == "default" else f"_{rec['rules']}"
    if rec.get("tag"):
        suffix += f"_{rec['tag']}"
    fn = os.path.join(
        out_dir, f"{_slug(rec['arch'])}_{rec['shape']}_{rec['mesh']}{suffix}.json"
    )
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def _parse_cfg(kvs):
    out = {}
    for kv in kvs or []:
        k, v = kv.split("=", 1)
        if v in ("True", "true"):
            v = True
        elif v in ("False", "false"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--save-ops", action="store_true",
                    help="also write a gzipped table of the traced ops a cell")
    ap.add_argument("--rules", default=None, help="sharding rule set name")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--cfg", action="append", default=None,
                    help="model-config override key=value (repeatable)")
    ap.add_argument("--tag", default="", help="variant tag for output files")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a worker process of its own world")
    args = ap.parse_args(argv)
    cfg_overrides = _parse_cfg(args.cfg)

    from . import cells as C

    if args.all:
        todo = C.all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    jobs = [(arch, shape, mp, args.out, args.save_ops, args.rules, args.microbatches,
             cfg_overrides, args.tag) for arch, shape in todo for mp in meshes]
    n_ok = n_skip = n_err = 0
    for rec in _run_all(jobs, args.jobs):
        arch, shape = rec["arch"], rec["shape"]
        tag = rec["status"]
        if tag == "ok":
            n_ok += 1
            r = rec["roofline"]
            print(
                f"[ok]   {arch:24s} {shape:12s} {rec['mesh']:8s} "
                f"trace={rec['compile_s']:7.1f}s "
                f"C={r['compute_s']:.3e} M={r['memory_s']:.3e} "
                f"X={r['collective_s']:.3e} dom={r['dominant']:10s} "
                f"mem/chip={rec['memory']['total_bytes']/2**30:.2f}GiB "
                f"fits={rec['fits']}",
                flush=True,
            )
        elif tag == "skipped":
            n_skip += 1
            print(f"[skip] {arch:24s} {shape:12s} {rec['mesh']:8s} {rec['reason']}",
                  flush=True)
        else:
            n_err += 1
            print(f"[ERR]  {arch:24s} {shape:12s} {rec['mesh']:8s} {rec['error']}",
                  flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
