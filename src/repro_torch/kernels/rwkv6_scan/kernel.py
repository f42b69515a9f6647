"""CUDA launch wrappers of the RWKV6 scan (K6) and of its backward.

The forward replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/rwkv6_scan/kernel.py``; the kernels are
``rwkv6_scan_kernel`` and ``rwkv6_scan_bwd_kernel`` in
``csrc/model_kernels.cu`` (its header gives the design and the bound).  The
backward has no Pallas counterpart: the reference differentiates its
``lax.scan``."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cuda_lib

HEAD_DIMS = (16, 32, 64, 128)
# warps a head takes in the per-head layout (a warp owns 64 columns of S at
# hd 64, 32 at hd 32 and 128, 16 at hd 16) and in the column split (8
# columns a warp), as rw_dispatch in csrc/model_kernels.cu lays them out
HEAD_WARPS = {16: 1, 32: 1, 64: 1, 128: 4}
SPLIT_COLS = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The backward's launch (RbPlan and rb_bytes in csrc/model_kernels.cu):
# a (batch, head) is a cluster of hd / BWD_COLS CTAs, each owning BWD_COLS
# columns of S and G; a thread holds one row and BWD_COLS / 2 of its CTA's
# columns (two threads a row); S is checkpointed before every BWD_CHUNK-th
# step, and a chunk's S_{t-1} stays in the registers (8 steps x 8 elements a
# thread), so BWD_CHUNK is 8 at every head width.
BWD_COLS = 16
BWD_CHUNK = {hd: 8 for hd in HEAD_DIMS}


class BwdPlan(NamedTuple):
    cluster: int     # CTAs a (batch, head): the grid is B * H * cluster
    threads: int     # threads a CTA
    chunk: int       # steps between checkpoints
    smem_bytes: int  # dynamic shared memory a CTA


def bwd_plan(hd: int, dtype=torch.bfloat16) -> BwdPlan:
    """K6's backward launch at head width ``hd`` for r, k, v of ``dtype``,
    as ``rb_launch`` makes it.  Shared memory (``rb_bytes``): u, and by
    chunk parity beta, dd and the finalize's four operands of the CTA's
    rows; by chunk parity the chunk as copied (r, k, v in their type, w and
    dout f32), by chunk mod 4 the row sums (dr, dk, dw) and by chunk parity
    the warps' dv sums (the forward pass's copy ring reuses this region)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    ck, threads, cols = BWD_CHUNK[hd], 2 * hd, BWD_COLS
    el = torch.empty((), dtype=dtype).element_size()
    misc = 4 * (hd + 2 * 2 * ck + 2 * 4 * ck * cols)
    chunk = ck * hd * (3 * el + 2 * 4)
    rev = 2 * chunk + 4 * (4 * 3 * ck * hd + 2 * ck * (threads // 32) * cols)
    return BwdPlan(hd // cols, threads, ck, misc + rev)


def column_split(heads: int, hd: int, sms: int) -> bool:
    """Whether a launch over ``heads`` (batch x head) pairs takes the column
    split: where the per-head layout would give fewer than 4 warps an SM,
    each head's columns spread over hd / 8 warps instead."""
    return heads * HEAD_WARPS[hd] < 4 * sms


def rwkv6_scan_cuda(r, k, v, w, u):
    """Outputs of the RWKV6 recurrence from a zero state.  r, k, v: (B, H,
    T, hd) CUDA tensors, all float32 or all bfloat16, widened as they are
    read; w: (B, H, T, hd) float32; any strides with the head width
    contiguous and 16-byte aligned rows (the model's (B, T, H, hd)
    projections seen as (B, H, T, hd)); u: (H, hd) float32, contiguous; hd
    in ``HEAD_DIMS``.  Returns (B, H, T, hd) float32 laid out as r is (a
    dense r's strides, else contiguous)."""
    b, h, t, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    if not r.is_cuda:
        raise ValueError("r must be a CUDA tensor")
    if r.dtype not in DTYPES:
        raise ValueError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, x, dtype in (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
                           ("w", w, torch.float32)):
        cuda_lib.check_strided(x, name, dtype, (b, h, t, hd))
    cuda_lib.check_operand(u, "u", torch.float32, (h, hd))
    out = torch.empty_like(r, dtype=torch.float32)
    strides = (ctypes.c_longlong * 15)(*(s for x in (r, k, v, w, out) for s in x.stride()[:3]))
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    stream = torch.cuda.current_stream(r.device).cuda_stream
    p = cuda_lib.ptr
    with torch.cuda.device(r.device):
        err = cuda_lib.lib().repro_rwkv6_scan(
            DTYPES[r.dtype], p(r), p(k), p(v), p(w), p(u), p(out), strides,
            b, h, t, hd, int(column_split(b * h, hd, sms)), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_rwkv6_scan failed with CUDA error {err}")
    cuda_lib.count_launch("rwkv6_scan")
    return out


def rwkv6_scan_bwd_cuda(r, k, v, w, u, dout):
    """(dr, dk, dv, dw, du) of :func:`rwkv6_scan_cuda` for the cotangent
    ``dout`` of its output: r, k, v, w and u as the forward takes them,
    dout (B, H, T, hd) float32 with its head width contiguous (any other
    strides).  dr, dk, dv come in r's type and layout (a dense r's strides),
    dw in w's, du (H, hd) float32; the same bits on every run (no atomics).
    Two launches: the recurrence in reverse, a thread-block cluster of
    ``bwd_plan(hd).cluster`` CTAs per (batch, head), each CTA owning
    ``BWD_COLS`` columns of S and G, recomputing its columns of S from
    checkpoints in a scratch tensor allocated here and summing the rows
    across the cluster through distributed shared memory; then du summed
    over the batch.  A launch the card refuses raises."""
    b, h, t, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    if not r.is_cuda:
        raise ValueError("r must be a CUDA tensor")
    if r.dtype not in DTYPES:
        raise ValueError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, x, dtype in (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
                           ("w", w, torch.float32), ("dout", dout, torch.float32)):
        cuda_lib.check_strided(x, name, dtype, (b, h, t, hd))
    cuda_lib.check_operand(u, "u", torch.float32, (h, hd))
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    du_part = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    # the checkpoints: S (hd x hd, by the cluster's CTAs) before every
    # BWD_CHUNK[hd]-th step of each (batch, head)
    ck = torch.empty(b * h * -(-t // BWD_CHUNK[hd]) * hd * hd, dtype=torch.float32,
                     device=r.device)
    strides = (ctypes.c_longlong * 27)(*(s for x in (r, k, v, w, dout, dr, dk, dv, dw)
                                         for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    p = cuda_lib.ptr
    with torch.cuda.device(r.device):
        err = cuda_lib.lib().repro_rwkv6_scan_bwd(
            DTYPES[r.dtype], p(r), p(k), p(v), p(w), p(u), p(dout), p(dr), p(dk), p(dv),
            p(dw), p(du), p(du_part), p(ck), strides, b, h, t, hd, BWD_CHUNK[hd],
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_rwkv6_scan_bwd failed with CUDA error {err}")
    cuda_lib.count_launch("rwkv6_scan_bwd")
    return dr, dk, dv, dw, du
