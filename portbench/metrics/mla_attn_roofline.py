"""Kernels (K5 at q/k width 192 and v width 128, ``csrc/model_kernels.cu``
``flash_attention_bf16_kernel<192, 128>``): the launches' summed bound over
their device time in the traced window, in %.  A launch is one MLA layer
of one scorer batch, at the batch's padded shape (B rows, H heads, S
positions), causal; its bound is max(ops / 989 TFLOP/s, bytes / 3.35 TB/s)
with ops 4 B H sum_t (t + 1) (192 + 128) / 2 and bytes q, k (192 wide), v
and o (128 wide) each moved once in bf16.  The batches are worked out from
the pairs the window scored (``reference/tokens.py``): one launch a layer
a batch.  A program without the kernel puts no such name in the trace,
and this reads nothing."""
import re

import numpy as np

from reference import tokens

DEVICE = True
KERNEL = re.compile(r"flash_attention_bf16_kernel<\s*192\s*,\s*128\s*>")
PEAK_BF16 = 989e12   # H100 SXM5, dense bf16 on the tensor cores
HBM_BW = 3.35e12
DQK, DV = 192, 128


def k5_work(b: int, h: int, s: int) -> tuple:
    """(operations, bytes) of one causal launch at (B, H, S)."""
    ops = 4.0 * b * h * (s * (s + 1) // 2) * (DQK + DV) / 2
    byts = 2.0 * b * h * s * (2 * DQK + 2 * DV)
    return ops, byts


def batch_shapes(ctx) -> list:
    """(rows, padded length) of every scorer batch of the window."""
    calls = getattr(getattr(ctx.oracle, "scorer", None), "calls", None)
    if not calls:
        return []
    sc = ctx.config["scorer"]
    bk = tokens.buckets(sc["max_len"])
    out = []
    for pairs, _ in calls:
        lens = tokens.prompt_lengths(pairs, ctx.oracle.left, ctx.oracle.right, sc["max_len"])
        pad_of = bk[np.searchsorted(bk, lens)]
        for pad_len in np.unique(pad_of):
            n = int((pad_of == pad_len).sum())
            out += [(sc["batch"], int(pad_len))] * -(-n // sc["batch"])
    return out


def read(ctx):
    tr = ctx.window.trace
    if tr is None:
        return None
    secs = sum(t for name, t in tr.device_time.items() if KERNEL.search(name))
    shapes = batch_shapes(ctx)
    if secs <= 0 or not shapes:
        return None
    m = ctx.config["model"]
    bound = 0.0
    for b, s in shapes:
        ops, byts = k5_work(b, m["num_heads"], s)
        bound += m["num_layers"] * max(ops / PEAK_BF16, byts / HBM_BW)
    return 100.0 * bound / secs
