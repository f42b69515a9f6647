"""Time the fp32 sweep and flash attention of one source tree on the card,
so that two trees can be compared in one call (run them in turns: A, B, B,
A):

    python scripts/compare_kernels.py --src src
    python scripts/compare_kernels.py --src build/parent/src

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (another commit unpacked with ``git archive`` under ``build/``); its
kernels build into that tree's own ``build/``.  The inputs are those of
``chip_smoke.py``: the fp32 sweep at the main path's shape (32,768 x 32,768
x 384, k 32, 4,096 bins, count tiles of 256 rows) on the clustered tables
of seed 0; the 3-way chain's first prefix launch (4,096 x 32,768 x 384,
exponent 0.5 with the per-row scale, walk sums at exponent 1, k 1); and
flash attention in bf16 at ``chip_smoke.FLASH_SHAPES`` (causal, normal
inputs from a seeded generator on the card).  Each time is the mean over
CUDA-event-timed launches after a warm-up.  Prints one JSON line with the
card's name and power limit.  Needs a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the src directory of the tree to time")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts this tree's src on sys.path: go first
    sys.path.insert(0, os.path.abspath(args.src))

    from repro_torch.core.stratify import _prefix_chain_weights
    from repro_torch.data import make_clustered_tables
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand, sim_sweep_cuda

    out = {"label": args.label or args.src}
    ds = make_clustered_tables(cs.FULL.n, cs.FULL.n, d=cs.FULL.d, n_entities=512,
                               noise=0.35, seed=cs.SEED)
    a = kernel_operand(torch.from_numpy(ds.emb1).cuda(), "fp32")
    b = kernel_operand(torch.from_numpy(ds.emb2).cuda(), "fp32")
    ones = torch.ones(a.shape[0], device="cuda")
    out["sweep_fp32_ms"] = events_ms(lambda: sim_sweep_cuda(
        a, b, ones, ones, n_bins=4096, k=32, bm=256), 5)
    del a, b, ds

    chain = cs.make_chain(cs.FULL)
    embs = chain.embeddings
    wp, i_last = _prefix_chain_weights(embs, 0, 4096, 1.0, 1e-3)
    pa = kernel_operand(torch.from_numpy(np.ascontiguousarray(embs[-2][i_last])).cuda(), "fp32")
    pb = kernel_operand(torch.from_numpy(embs[-1]).cuda(), "fp32")
    scale = torch.from_numpy((wp**0.5).astype(np.float32)).cuda()
    v = torch.ones(pb.shape[0], device="cuda")
    out["chain_prefix_ms"] = events_ms(lambda: sim_sweep_cuda(
        pa, pb, scale, v, n_bins=4096, exponent=0.5, rs_exponent=1.0, k=1, bm=256), 20)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    flash = {}
    for label, (bb, hq, hkv, s, d, causal, window) in cs.FLASH_SHAPES.items():
        q = torch.randn((bb, hq, s, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((bb, hkv, s, d), generator=gen, device="cuda").bfloat16()
        vv = torch.randn((bb, hkv, s, d), generator=gen, device="cuda").bfloat16()
        flash[label] = events_ms(lambda: flash_attention_cuda(
            q, k, vv, causal=causal, window=window), 20)
    out["flash_bf16_ms"] = flash
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
