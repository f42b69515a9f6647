"""CUDA launch wrapper of the RWKV6 scan (K6).

Replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/rwkv6_scan/kernel.py``; the kernel is
``rwkv6_scan_kernel`` in ``csrc/model_kernels.cu`` (its header gives the
design and the bound)."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

HEAD_DIMS = (16, 32, 64, 128)


def rwkv6_scan_cuda(r, k, v, w, u):
    """Outputs of the RWKV6 recurrence from a zero state, for contiguous
    float32 CUDA tensors r, k, v, w (B, H, T, hd) and u (H, hd), hd in
    ``HEAD_DIMS``.  Returns (B, H, T, hd) float32."""
    b, h, t, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        cuda_lib.check_operand(x, name, torch.float32, (b, h, t, hd))
    cuda_lib.check_operand(u, "u", torch.float32, (h, hd))
    out = torch.empty_like(r)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    p = cuda_lib.ptr
    with torch.cuda.device(r.device):
        err = cuda_lib.lib().repro_rwkv6_scan(
            p(r), p(k), p(v), p(w), p(u), p(out), b, h, t, hd,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_rwkv6_scan failed with CUDA error {err}")
    cuda_lib.LAUNCHES["rwkv6_scan"] += 1
    return out
