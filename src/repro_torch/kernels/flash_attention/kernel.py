"""CUDA launch wrapper of GQA flash attention (K5).

Replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/flash_attention/kernel.py``; the kernels are in
``csrc/model_kernels.cu`` (its header gives the design and the bound):
``flash_attention_bf16_kernel`` on the tensor cores for bfloat16 and the
SIMT ``flash_attention_kernel`` for float32."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_cuda(q, k, v, causal=True, window=0):
    """``softmax(q k^T d**-0.5 + mask) v`` for contiguous CUDA tensors q
    (B, Hq, Sq, d) and k, v (B, Hkv, Skv, d) of one type (float32 or
    bfloat16), Hq a multiple of Hkv, d in ``HEAD_DIMS``.  Returns (B, Hq,
    Sq, d) in q's type."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} q heads do not split into {hkv} KV heads")
    cuda_lib.check_operand(q, "q", q.dtype, (b, hq, sq, d))
    cuda_lib.check_operand(k, "k", q.dtype, (b, hkv, skv, d))
    cuda_lib.check_operand(v, "v", q.dtype, (b, hkv, skv, d))
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = cuda_lib.lib().repro_flash_attention(
            DTYPES[q.dtype], cuda_lib.ptr(q), cuda_lib.ptr(k), cuda_lib.ptr(v),
            cuda_lib.ptr(o), b, hq, hkv, sq, skv, d, int(bool(causal)),
            int(window), float(d**-0.5), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_flash_attention failed with CUDA error {err}")
    cuda_lib.count_launch("flash_attention")
    return o
