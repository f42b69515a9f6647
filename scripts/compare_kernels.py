"""Time the kernels of one source tree on the card, so that two trees can be
compared in one call (run them in turns: A, B, B, A):

    python scripts/compare_kernels.py --src src
    python scripts/compare_kernels.py --src build/parent/src
    python scripts/compare_kernels.py --src src --epilogue-floor
    python scripts/compare_kernels.py --src src --few-row-cut
    python scripts/compare_kernels.py --src src --scan-bwd

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (another commit unpacked with ``git archive`` under ``build/``); its
kernels build into that tree's own ``build/``.  The inputs are those of
``chip_smoke.py``:

* the sweep at the main path's shape (32,768 x 32,768 x 384, k 32, 4,096
  bins, count tiles of 256 rows) on the clustered tables of seed 0, at fp32
  (K1), bf16 (K1 bf16) and int8 (K2), and the two-pass top-k (K3, k 32) and
  histogram (K4) at fp32;
* the raised-k retry (K3, k 128) on its shape: ``chip_smoke.HOT_ROWS`` hot
  rows against the hot catalog's 32,768 right rows, padded as
  ``chip_smoke.retry_operands`` pads them;
* the 3-way chain's first prefix launch (4,096 x 32,768 x 384, exponent 0.5
  with the per-row scale, walk sums at exponent 1, k 1);
* flash attention in bf16 at ``chip_smoke.FLASH_SHAPES`` (causal, normal
  inputs from a seeded generator on the card);
* the RWKV6 scan (K6) at ``chip_smoke.RWKV_SHAPES``: on f32 (B, H, T, hd)
  operands, and as the tree's model calls it on bf16 (B, T, H, hd)
  projections (a tree whose kernel takes only contiguous f32 gets the
  copies its model made: ``.float().transpose(1, 2)`` and the op's
  ``.contiguous()``).

``--few-row-cut`` times the fp32 top-k at k 128 against the hot catalog's
32,768 right rows over 1, 8, 16, 24 and 32 of its rows (the few-row
kernels' range), as ``cuda_lib.launch`` launches it and through the tile
kernel's own launch (``cuda_lib._launch_tile``), which ``launch`` takes
above the cut.

``--scan-bwd`` times K6's backward alone at ``chip_smoke.RWKV_BWD_SHAPE``
(rwkv6-1.6b's training shape) and ``RWKV_BWD_OTHER_SHAPES``.

``--epilogue-floor`` builds the tree's kernels with
``-DREPRO_SIM_EPILOGUE_FLOOR`` (into its own library) and times the bf16
and int8 sweeps only: their product warps compute each CTA's first column
tile and stage those scores again for every other tile, so the time is the
epilogues' with a product that costs next to nothing.

Each time is the mean over CUDA-event-timed calls after a warm-up; for the
top-k at k 128, whose calls are short enough that the host's work between
them shows, also the device time of each kernel a call launches
(torch.profiler).  Prints one JSON line with the card's name and power
limit.  Needs a CUDA card.
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


def sweeps(cs, floor_only):
    """K1-K4 at the main path's shape: {name: ms}."""
    from repro_torch.core.similarity import quantize_rows_int8
    from repro_torch.data import make_clustered_tables
    from repro_torch.kernels.sim_hist.kernel import sim_hist_cuda
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand, sim_sweep_cuda
    from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda

    ds = make_clustered_tables(cs.FULL.n, cs.FULL.n, d=cs.FULL.d, n_entities=512,
                               noise=0.35, seed=cs.SEED)
    e1, e2 = torch.from_numpy(ds.emb1).cuda(), torch.from_numpy(ds.emb2).cuda()
    ones = torch.ones(e1.shape[0], device="cuda")
    kw = dict(n_bins=4096, k=32, bm=256)
    out = {}
    for precision in ("bf16", "int8") if floor_only else ("fp32", "bf16", "int8"):
        rs1 = rs2 = None
        a, b = e1, e2
        if precision == "int8":
            q1, r1 = quantize_rows_int8(ds.emb1)
            q2, r2 = quantize_rows_int8(ds.emb2)
            a, b, rs1, rs2 = (torch.from_numpy(x).cuda() for x in
                              (q1, q2, r1.reshape(-1), r2.reshape(-1)))
        ka, kb = kernel_operand(a, precision), kernel_operand(b, precision)
        out[f"sweep_{precision}_ms"] = events_ms(lambda: sim_sweep_cuda(
            ka, kb, ones, ones, precision=precision, rs1=rs1, rs2=rs2, **kw), 5)
        del ka, kb
    if not floor_only:
        a4, b4 = kernel_operand(e1, "fp32"), kernel_operand(e2, "fp32")
        out["topk_k32_ms"] = events_ms(lambda: sim_topk_cuda(a4, b4, k=32), 3)
        out["hist_ms"] = events_ms(lambda: sim_hist_cuda(a4, b4, ones, n_bins=4096), 3)
    return out


def retry(cs):
    """K3 at k 128 on the raised-k retry's shape: the time of a call, and
    the device time of each kernel it launches."""
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand
    from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda

    h1p, hb = cs.retry_operands(cs.make_hot(cs.FULL.n, cs.FULL.d, cs.SEED), cs.HOT_ROWS)
    a4, b4 = kernel_operand(h1p, "fp32"), kernel_operand(hb, "fp32")
    fn = lambda: sim_topk_cuda(a4, b4, k=128)  # noqa: E731
    by_kernel = cs.device_ms_by_kernel(fn, 20)
    return {"retry_topk_k128_ms": events_ms(fn, 50),
            "retry_topk_k128_device_ms": sum(by_kernel.values()),
            "retry_topk_k128_device_ms_by_kernel": by_kernel}


def few_row_cut(cs):
    """The top-k at k 128 over few rows: {rows: {kernel: ms a call, device
    ms}} for the few-row kernels and the tile kernel."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand

    hot = cs.make_hot(cs.FULL.n, cs.FULL.d, cs.SEED)
    out = {}
    for rows in (1, 8, 16, 24, 32):
        h1p, hb = cs.retry_operands(hot, rows)
        a4, b4 = kernel_operand(h1p[:rows], "fp32"), kernel_operand(hb, "fp32")
        assert cuda_lib.few_rows("fp32", cuda_lib.TOPK, rows)
        out[rows] = {}
        for name, launch in (("few-row", cuda_lib.launch), ("tile", cuda_lib._launch_tile)):
            fn = lambda: launch("fp32", cuda_lib.TOPK, a4, b4, k=128)  # noqa: E731
            out[rows][name] = {"ms": events_ms(fn, 50),
                               "device_ms": sum(cs.device_ms_by_kernel(fn, 20).values())}
    return out


def chain_prefix_ms(cs):
    from repro_torch.core.stratify import _prefix_chain_weights
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand, sim_sweep_cuda

    embs = cs.make_chain(cs.FULL).embeddings
    wp, i_last = _prefix_chain_weights(embs, 0, 4096, 1.0, 1e-3)
    pa = kernel_operand(torch.from_numpy(np.ascontiguousarray(embs[-2][i_last])).cuda(), "fp32")
    pb = kernel_operand(torch.from_numpy(embs[-1]).cuda(), "fp32")
    scale = torch.from_numpy((wp**0.5).astype(np.float32)).cuda()
    v = torch.ones(pb.shape[0], device="cuda")
    return events_ms(lambda: sim_sweep_cuda(
        pa, pb, scale, v, n_bins=4096, exponent=0.5, rs_exponent=1.0, k=1, bm=256), 20)


def flash_ms(cs, gen):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    out = {}
    for label, (bb, hq, hkv, sq, skv, d, causal, window) in cs.FLASH_SHAPES.items():
        q = torch.randn((bb, hq, sq, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((bb, hkv, skv, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((bb, hkv, skv, d), generator=gen, device="cuda").bfloat16()
        out[label] = events_ms(lambda: flash_attention_cuda(
            q, k, v, causal=causal, window=window), 20)
    return out


def rwkv_ms(cs, gen):
    """K6 at each shape: on f32 (B, H, T, hd) operands, and as the model
    calls the op on its bf16 (B, T, H, hd) projections."""
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    takes_views = hasattr(rk, "column_split")
    out = {}
    for label, (b, h, t, hd) in cs.RWKV_SHAPES.items():
        proj = [torch.randn((b, t, h, hd), generator=gen, device="cuda").bfloat16()
                for _ in range(3)]
        w = torch.exp(-torch.exp(torch.empty((b, t, h, hd), device="cuda")
                                 .uniform_(-8.0, -4.0, generator=gen)))
        u = 0.1 * torch.randn((h, hd), generator=gen, device="cuda")
        f32 = [z.float().transpose(1, 2).contiguous() for z in (*proj, w)]
        out[f"{label}, f32 (B, H, T, hd)"] = events_ms(lambda: rk.rwkv6_scan_cuda(*f32, u), 20)
        view = (lambda z: z.transpose(1, 2)) if takes_views else (
            lambda z: z.float().transpose(1, 2))
        out[f"{label}, model call, bf16 (B, T, H, hd)"] = events_ms(
            lambda: rwkv6_scan(*(view(z) for z in (*proj, w)), u), 20)
    return out


def scan_bwd_ms(cs, gen):
    """K6's backward at ``chip_smoke.RWKV_BWD_SHAPE`` and
    ``RWKV_BWD_OTHER_SHAPES``, on bf16 (B, T, H, hd) projections seen as (B,
    H, T, hd), the model's decays and an f32 cotangent in the same layout."""
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_cuda

    out = {}
    for label, (b, h, t, hd) in [cs.RWKV_BWD_SHAPE, *cs.RWKV_BWD_OTHER_SHAPES.items()]:
        view = lambda z: z.transpose(1, 2)  # noqa: E731
        r, k, v = (view(torch.randn((b, t, h, hd), generator=gen, device="cuda").bfloat16())
                   for _ in range(3))
        w = view(torch.exp(-torch.exp(torch.empty((b, t, h, hd), device="cuda")
                                      .uniform_(-8.0, -4.0, generator=gen))))
        u = 0.1 * torch.randn((h, hd), generator=gen, device="cuda")
        do = view(torch.randn((b, t, h, hd), generator=gen, device="cuda"))
        out[label] = events_ms(lambda: rwkv6_scan_bwd_cuda(r, k, v, w, u, do), 10)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the src directory of the tree to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--few-row-cut", action="store_true",
                    help="time the few-row and the tile top-k over 1 to 32 rows")
    ap.add_argument("--epilogue-floor", action="store_true",
                    help="time the bf16 and int8 sweeps of the epilogue-floor build only")
    ap.add_argument("--scan-bwd", action="store_true",
                    help="time K6's backward only, at phase 3c's shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts this tree's src on sys.path: go first
    sys.path.insert(0, os.path.abspath(args.src))

    from repro_torch.kernels import cuda_lib

    out = {"label": args.label or args.src}
    if args.few_row_cut:
        out["topk_k128_by_rows"] = few_row_cut(cs)
    elif args.scan_bwd:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        out["rwkv6_scan_bwd_ms"] = scan_bwd_ms(cs, gen)
    elif args.epilogue_floor:
        cuda_lib.NVCC_FLAGS = [*cuda_lib.NVCC_FLAGS, "-DREPRO_SIM_EPILOGUE_FLOOR"]
        out["epilogue_floor"] = True
        out.update(sweeps(cs, floor_only=True))
    else:
        out.update(sweeps(cs, floor_only=False))
        out.update(retry(cs))
        out["chain_prefix_ms"] = chain_prefix_ms(cs)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        out["flash_bf16_ms"] = flash_ms(cs, gen)
        out["rwkv6_scan_ms"] = rwkv_ms(cs, gen)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
