"""CUDA launch wrappers of the RWKV6 scan (K6) and of its backward.

The forward replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/rwkv6_scan/kernel.py``; the kernels are
``rwkv6_scan_kernel`` and ``rwkv6_scan_bwd_kernel`` in
``csrc/model_kernels.cu`` (its header gives the design and the bound).  The
backward has no Pallas counterpart: the reference differentiates its
``lax.scan``."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

HEAD_DIMS = (16, 32, 64, 128)
# warps a head takes in the per-head layout (a warp owns 64 columns of S at
# hd 64, 32 at hd 32 and 128, 16 at hd 16) and in the column split (8
# columns a warp), as rw_dispatch in csrc/model_kernels.cu lays them out
HEAD_WARPS = {16: 1, 32: 1, 64: 1, 128: 4}
SPLIT_COLS = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# steps between the backward's checkpoints of S, per head width (CK of
# rb_dispatch in csrc/model_kernels.cu: a chunk's states fill at most 128 KB
# of shared memory)
BWD_CHUNK = {16: 16, 32: 16, 64: 8, 128: 2}


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
    Two launches: the recurrence in reverse, one CTA per (batch, head),
    recomputing S from checkpoints in a scratch tensor allocated here; then
    du summed over the batch."""
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
    # the checkpoints: S (hd x hd) before every BWD_CHUNK[hd]-th step of each
    # (batch, head)
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
