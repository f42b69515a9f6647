"""Kernels (K1, ``csrc/sim_kernels.cu``): the sweep's bound at the cell's
shape over the device time of the sweep's kernels per completed query, in
%.  The bound is max(2 m n d / 67 TFLOP/s, bytes / 3.35 TB/s) from the
frozen copy of the sweep's work; the fp32 sweep may not use TF32, so its
peak is the CUDA cores'."""
from harness.yardstick import bound_s, sim_sweep

DEVICE = True
# the fused sweep's kernel and its column-split merge
KERNELS = ("sim_kernel", "split_merge")


def read(ctx):
    tr, done = ctx.window.trace, ctx.window.completed
    if tr is None or not done:
        return None
    secs = sum(s for name, s in tr.device_time.items() if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    (n1, d), (n2, _) = ctx.tables.emb[0].shape, ctx.tables.emb[1].shape
    ops, byts, peak = sim_sweep(n1, n2, d, ctx.mix.get("bas", {}).get("sweep_precision", "fp32"))
    return 100.0 * bound_s(ops, byts, peak) * len(done) / secs
