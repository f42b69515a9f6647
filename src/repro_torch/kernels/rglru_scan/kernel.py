"""CUDA launch wrappers of the RG-LRU scan (K7) and of its backward.

The forward replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/rglru_scan/kernel.py``; the kernels are
``rglru_scan_kernel`` and ``rglru_scan_bwd_kernel`` in
``csrc/model_kernels.cu`` (its header gives the design and the bound).  The
backward has no Pallas counterpart: the reference differentiates its
``lax.scan``."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib


def rglru_scan_cuda(a, g):
    """``h_t = a_t h_{t-1} + g_t`` from ``h = 0`` for contiguous float32
    CUDA tensors a, g (B, T, R).  Returns (B, T, R) float32."""
    b, t, r = a.shape
    cuda_lib.check_operand(a, "a", torch.float32, (b, t, r))
    cuda_lib.check_operand(g, "g", torch.float32, (b, t, r))
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    p = cuda_lib.ptr
    with torch.cuda.device(a.device):
        err = cuda_lib.lib().repro_rglru_scan(
            p(a), p(g), p(out), b, t, r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"repro_rglru_scan failed with CUDA error {err}")
    cuda_lib.count_launch("rglru_scan")
    return out


def rglru_scan_bwd_cuda(a, h, dout):
    """(da, dg) of :func:`rglru_scan_cuda` for the cotangent ``dout`` of its
    output ``h``: contiguous float32 CUDA tensors (B, T, R).  Returns
    (B, T, R) float32 each."""
    b, t, r = a.shape
    for name, x in (("a", a), ("h", h), ("dout", dout)):
        cuda_lib.check_operand(x, name, torch.float32, (b, t, r))
    da, dg = torch.empty_like(a), torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    p = cuda_lib.ptr
    with torch.cuda.device(a.device):
        err = cuda_lib.lib().repro_rglru_scan_bwd(
            p(a), p(h), p(dout), p(da), p(dg), b, t, r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"repro_rglru_scan_bwd failed with CUDA error {err}")
    cuda_lib.count_launch("rglru_scan_bwd")
    return da, dg
