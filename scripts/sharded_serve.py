"""Sharded decode on four cards (``models.decode_step`` under
``DECODE_RULES`` on parameters laid out by ``models.partition.shard_params``
and a cache laid out by ``shard_cache``: the weights 2-D over "model" x
"data", the cache's 32,768 slots over "model", its batch over "data"), one
rank a card over NCCL:

    python scripts/sharded_serve.py                 # 4 cards
    python scripts/sharded_serve.py --device cpu    # rehearsal: the smoke config, gloo

On a 2 x 2 ("data", "model") mesh it decodes the full 40-layer
``mistral-nemo-12b`` (published widths, bf16 weights from ``--seed``), a
batch of 16, 16 steps at positions 32,752-32,767 of a cache of 32,768
slots whose K/V are drawn from ``--seed`` (a layer's K or V drawn whole
on each rank, its block kept): 85.9 GB of cache and 24.5 GB of weights
whole, 21.5 and 6.1 GB a rank.  First the same model cut to 4 layers, whose
first step (the ranks' rows and vocabulary columns gathered) is held
against the one-card decode of that model and cache on card 0, within the
trainer's bf16 rule (6e-2 of the largest |logit|).  Each rank logs the
ms of its first 12 steps with their collectives timed (the device
synchronised around each), of 2 steps bare and, on the card, of the last
2 under ``torch.profiler`` (the device's busy ms and its top kernels), and
its peak memory; the last line is one JSON object of the jobs, the held
ratio and the cards' names and power limits.
"""
import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
import uuid

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

NAME = "mistral-nemo-12b"
BATCH, SLOTS, STEPS, CUT = 16, 32768, 16, 4
REHEARSAL = dict(batch=4, slots=64, steps=6)
BOUND_S = 900.0


def _sizes(device):
    return dict(batch=BATCH, slots=SLOTS, steps=STEPS) if device == "cuda" else REHEARSAL


def _config(device, layers=None):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_config(NAME) if device == "cuda" else get_smoke_config(NAME)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def seeded_cache(cfg, batch, slots, seed, device, mesh=None, rules=None):
    """A cache whose K/V rows are normal draws from ``seed``, one layer's K
    or V at a time drawn whole (the same on every rank) and the rank's
    block kept; whole on ``device`` without a mesh."""
    from repro_torch.launch.sharding import local_block
    from repro_torch.models import init_cache
    from repro_torch.models.partition import cache_shardings
    from repro_torch.train.sharded import local

    if mesh is None:
        cache, shardings = init_cache(cfg, batch, slots, device), None
    else:
        cache = init_cache(cfg, batch, slots, mesh=mesh, rules=rules)
        shardings = cache_shardings(init_cache(cfg, batch, slots, "meta"), mesh, rules)
    for j, key in enumerate(("k", "v")):
        blocks = local(cache[key])
        for layer in range(cfg.num_layers):
            gen = torch.Generator(device=device).manual_seed(seed * 1000 + 2 * layer + j)
            whole = torch.randn(cache[key].shape[1:], generator=gen, device=device,
                                dtype=blocks.dtype)
            if shardings is not None:
                sh = shardings[key]
                whole = local_block(whole, dataclasses.replace(sh, spec=sh.spec[1:]))
            blocks[layer].copy_(whole)
            del whole
    return cache


def _tokens(cfg, seed, batch, steps):
    import numpy as np

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (steps, batch, 1)))


def decode_job(device, seed, layers, out_dir):
    """A rank's job: the model (``layers`` of it, else all) and cache laid
    out on the 2 x 2 mesh, ``STEPS`` steps; returns the logged row and
    writes rank 0's first step (gathered) for the cut model."""
    import chip_smoke
    import torch.distributed as dist

    from repro_torch.launch.cells import tree_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import DECODE_RULES, sharding_context
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.partition import shard_params
    from repro_torch.train.sharded import gather_dim, top

    sz = _sizes(device)
    cfg = _config(device, layers)
    rank = dist.get_rank()
    params = init_params(cfg, seed, device=device)
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    shard_params(params, mesh, DECODE_RULES)
    chip_smoke._free()
    cache = seeded_cache(cfg, sz["batch"], sz["slots"], seed, device, mesh, DECODE_RULES)
    at = mesh.coordinate()
    n = sz["batch"] // 2
    tokens = _tokens(cfg, seed, sz["batch"], sz["steps"])[:, at["data"] * n:(at["data"] + 1) * n]
    with sharding_context(mesh, DECODE_RULES):
        split = top(params)[1].n > 1
    row = {"job": f"{NAME} {cfg.num_layers} layers 2x2", "rank": rank,
           "backend": dist.get_backend(), "layers": cfg.num_layers, "batch": sz["batch"],
           "slots": sz["slots"], "held_param_bytes": tree_bytes(params),
           "held_cache_bytes": tree_bytes(cache),
           "step_ms": [], "collective_ms": [], "bare_step_ms": [], "profiled": []}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    finite = True
    for i in range(sz["steps"]):
        position = sz["slots"] - sz["steps"] + i

        def step():
            with sharding_context(mesh, DECODE_RULES):
                return decode_step(cfg, params, cache, tokens[i].to(device), position)

        kind = "timed" if i < sz["steps"] - 4 else "bare" if i < sz["steps"] - 2 \
            else "profiled"
        if kind == "profiled" and device == "cuda":
            (logits, cache), wall, busy, top = chip_smoke._profiled(step)
            row["profiled"].append({"step_ms": wall, "busy_ms": busy, "top": top[:12]})
        else:
            timer = chip_smoke._TimedCollectives(device) if kind == "timed" \
                else contextlib.nullcontext()
            with timer:
                chip_smoke.sync(device)
                t0 = time.perf_counter()
                logits, cache = step()
                chip_smoke.sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            if kind == "timed":
                row["step_ms"].append(ms)
                row["collective_ms"].append(dict(timer.ms))
            else:
                row["bare_step_ms"].append(ms)
        finite &= bool(torch.isfinite(logits).all())
        if i == 0 and layers:
            if split:
                logits = gather_dim(logits, 1, mesh.group(("model",)), 2)
            logits = gather_dim(logits, 0, mesh.group(("data",)), 2).cpu()
            if rank == 0:
                torch.save(logits, os.path.join(out_dir, "first_step.pt"))
    row["finite"] = finite
    if device == "cuda":
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del params, cache
    chip_smoke._free()
    return row


def rank_main(rank, world, store, device, seed, out_dir):
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        rows = [decode_job(device, seed, layers, out_dir) for layers in (CUT, None)]
    finally:
        dist.destroy_process_group()
    print(json.dumps(rows), flush=True)


def one_card_first_step(device, seed):
    """The cut model's first step on one card, unsharded, from the same
    weights, cache and tokens."""
    from repro_torch.models import decode_step, init_params

    sz = _sizes(device)
    cfg = _config(device, CUT)
    params = init_params(cfg, seed, device=device)
    cache = seeded_cache(cfg, sz["batch"], sz["slots"], seed, device)
    tokens = _tokens(cfg, seed, sz["batch"], sz["steps"])
    logits, _ = decode_step(cfg, params, cache, tokens[0].to(device), sz["slots"] - sz["steps"])
    return logits.cpu()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cards = None
    if args.device == "cuda":
        if torch.cuda.device_count() < 4:
            sys.exit(f"needs 4 CUDA cards, found {torch.cuda.device_count()}")
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip().splitlines()
    out_dir = os.path.join(HERE, "build", "sharded_serve")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, f"store_{uuid.uuid4().hex}")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), PYTHONFAULTHANDLER="1")
    procs = []
    for rank in range(4):
        code = ("import sys; sys.path.insert(0, {here!r}); sys.path.insert(0, {scripts!r}); "
                "import sharded_serve; sharded_serve.rank_main({rank}, 4, {store!r}, "
                "{device!r}, {seed}, {out!r})").format(
                    here=HERE, scripts=os.path.join(HERE, "scripts"), rank=rank, store=store,
                    device=args.device, seed=args.seed, out=out_dir)
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=HERE, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    rows, errs = [], []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=BOUND_S)
            if proc.returncode != 0:
                errs.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
            else:
                rows += json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if os.path.exists(store):
            os.remove(store)
    if errs:
        sys.exit("\n".join(errs))
    for r in rows:
        print(json.dumps(r), flush=True)
    want = one_card_first_step(args.device, args.seed)
    got = torch.load(os.path.join(out_dir, "first_step.pt"))
    held = float((got.float() - want.float()).abs().max()) / (
        6e-2 * float(want.float().abs().max()))
    finite = all(r["finite"] for r in rows)
    jobs = {}
    for r in rows:
        job = jobs.setdefault(r["job"], {"step_ms": {}, "collective_ms": {},
                                         "bare_step_ms": {}, "profiled": {},
                                         "max_memory_allocated_bytes": {},
                                         "held_param_bytes": {}, "held_cache_bytes": {}})
        for key in job:
            job[key][r["rank"]] = r.get(key)
    print(json.dumps({"cards": cards, "held_ratio_first_step": held, "finite": finite,
                      "jobs": jobs}), flush=True)
    if held > 1.0 or not finite:
        sys.exit(f"the first step is {held} of the bf16 rule from one card's, finite {finite}")


if __name__ == "__main__":
    main()
