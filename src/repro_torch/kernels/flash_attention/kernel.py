"""CUDA launch wrappers of GQA flash attention (K5) and of its backward.

The forward replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/flash_attention/kernel.py``; the kernels are in
``csrc/model_kernels.cu`` (its header gives the design and the bound):
``flash_attention_bf16_kernel`` on the tensor cores for bfloat16 and the
SIMT ``flash_attention_kernel`` for float32.  The backward has no Pallas
counterpart (the reference differentiates its jnp attention): kernels of
the same file that recompute P from the row log-sum-exp that the forward
saves when it is asked for it, on the tensor cores for bfloat16
(``fa_bwd_dq_bf16_kernel``, ``fa_bwd_dkv_bf16_kernel``, whose dK/dV CTAs
split a group's q heads by :func:`head_split`, and
``fa_bwd_dkv_sum_kernel``), SIMT for float32 (``fa_bwd_dq_kernel``,
``fa_bwd_dkv_kernel``), after ``fa_bwd_delta_kernel``."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def dkv_keys(d: int) -> int:
    """Keys of a bf16 dK/dV CTA (``FcKv::BK`` in the source): 4 warps of 16
    keys, or of 16 keys and 128 columns at d 256.  Only ``head_split``
    reads it, to count CTAs; the C side takes its split from ``per``."""
    return 64 if d <= 128 else 32


def head_split(b: int, hkv: int, skv: int, d: int, group: int, sms: int):
    """(q heads a bf16 dK/dV CTA takes, CTAs a group's heads split into).
    One CTA per (batch, KV head, KV tile) that walks every q head of the
    group leaves SMs idle under GQA and MQA; the heads spread over enough
    CTAs for about two per SM, at most one head each.  The splits' f32
    partials are summed in split order, so the same shape gives the same
    bits on every run."""
    ctas = b * hkv * -(-skv // dkv_keys(d))
    want = max(1, min(group, -(-2 * sms // ctas)))
    per = -(-group // want)
    return per, -(-group // per)


def _check(q, k, v):
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
    return b, hq, hkv, sq, skv, d


def flash_attention_cuda(q, k, v, causal=True, window=0, with_lse=False):
    """``softmax(q k^T d**-0.5 + mask) v`` for contiguous CUDA tensors q
    (B, Hq, Sq, d) and k, v (B, Hkv, Skv, d) of one type (float32 or
    bfloat16), Hq a multiple of Hkv, d in ``HEAD_DIMS``.  Returns (B, Hq,
    Sq, d) in q's type, and with ``with_lse`` also the (B, Hq, Sq) float32
    row log-sum-exp of the scaled, masked scores (what the backward
    reads)."""
    b, hq, hkv, sq, skv, d = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = cuda_lib.lib().repro_flash_attention(
            DTYPES[q.dtype], cuda_lib.ptr(q), cuda_lib.ptr(k), cuda_lib.ptr(v),
            cuda_lib.ptr(o), cuda_lib.ptr(lse), b, hq, hkv, sq, skv, d,
            int(bool(causal)), int(window), float(d**-0.5), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_flash_attention failed with CUDA error {err}")
    cuda_lib.count_launch("flash_attention")
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=True, window=0):
    """(dq, dk, dv) of :func:`flash_attention_cuda` for the cotangent ``do``
    of its output ``o``, given the ``lse`` it returned; the gradients come
    in the inputs' type and shapes, the same bits on every run.  At bf16
    with more than one head split, the splits' f32 partial dK and dV go to
    a workspace allocated here."""
    b, hq, hkv, sq, skv, d = _check(q, k, v)
    cuda_lib.check_operand(o, "o", q.dtype, (b, hq, sq, d))
    cuda_lib.check_operand(do, "do", q.dtype, (b, hq, sq, d))
    cuda_lib.check_operand(lse, "lse", torch.float32, (b, hq, sq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    per, splits, wsk, wsv = hq // hkv, 1, None, None
    if q.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        per, splits = head_split(b, hkv, skv, d, hq // hkv, sms)
        if splits > 1:
            wsk, wsv = (torch.empty((splits, b, hkv, skv, d), dtype=torch.float32,
                                    device=q.device) for _ in range(2))
    p = cuda_lib.ptr
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = cuda_lib.lib().repro_flash_attention_bwd(
            DTYPES[q.dtype], p(q), p(k), p(v), p(o), p(do), p(lse), p(delta),
            p(dq), p(dk), p(dv), p(wsk), p(wsv), b, hq, hkv, sq, skv, d,
            int(bool(causal)), int(window), float(d**-0.5), per, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_flash_attention_bwd failed with CUDA error {err}")
    cuda_lib.count_launch("flash_attention_bwd")
    return dq, dk, dv
