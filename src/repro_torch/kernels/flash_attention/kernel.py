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
# (q and k width, v and output width) pairs of the bf16 forward beside the
# equal widths: latent attention's nope + rope against v (DeepSeek-V3)
WIDTH_PAIRS = ((192, 128),)


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


def _check(q, k, v, backward=False):
    """(b, hq, hkv, sq, skv, d, dv) of a launch's operands: q and k ``d``
    wide, v ``dv``, both in ``HEAD_DIMS`` and equal, or a pair of
    ``WIDTH_PAIRS`` in the bf16 forward."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if dv != d:
        if backward or q.dtype != torch.bfloat16 or (d, dv) not in WIDTH_PAIRS:
            raise ValueError(f"q/k width {d} against v width {dv}: unequal widths take "
                             f"the bf16 forward at {WIDTH_PAIRS} only")
    elif d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} q heads do not split into {hkv} KV heads")
    cuda_lib.check_operand(q, "q", q.dtype, (b, hq, sq, d))
    cuda_lib.check_operand(k, "k", q.dtype, (b, hkv, skv, d))
    cuda_lib.check_operand(v, "v", q.dtype, (b, hkv, skv, dv))
    return b, hq, hkv, sq, skv, d, dv


def launch_name(d: int, dv: int) -> str:
    """The key of a forward launch in ``cuda_lib.LAUNCHES``: unequal widths
    count apart, as the kernel's name tells them apart in a device trace
    (``flash_attention_bf16_kernel<192, 128>``)."""
    return "flash_attention" if d == dv else f"flash_attention_{d}_{dv}"


def flash_attention_cuda(q, k, v, causal=True, window=0, with_lse=False):
    """``softmax(q k^T d**-0.5 + mask) v`` for contiguous CUDA tensors q
    (B, Hq, Sq, d), k (B, Hkv, Skv, d) and v (B, Hkv, Skv, dv) of one type
    (float32 or bfloat16), Hq a multiple of Hkv, d = dv in ``HEAD_DIMS`` or,
    at bfloat16, (d, dv) in ``WIDTH_PAIRS``.  Returns (B, Hq, Sq, dv) in q's
    type, and with ``with_lse`` also the (B, Hq, Sq) float32 row
    log-sum-exp of the scaled, masked scores (what the backward reads)."""
    b, hq, hkv, sq, skv, d, dv = _check(q, k, v)
    o = q.new_empty((b, hq, sq, dv))
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = cuda_lib.lib().repro_flash_attention(
            DTYPES[q.dtype], cuda_lib.ptr(q), cuda_lib.ptr(k), cuda_lib.ptr(v),
            cuda_lib.ptr(o), cuda_lib.ptr(lse), b, hq, hkv, sq, skv, d, dv,
            int(bool(causal)), int(window), float(d**-0.5), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_flash_attention failed with CUDA error {err}")
    cuda_lib.count_launch(launch_name(d, dv))
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=True, window=0):
    """(dq, dk, dv) of :func:`flash_attention_cuda` for the cotangent ``do``
    of its output ``o``, given the ``lse`` it returned; the gradients come
    in the inputs' type and shapes, the same bits on every run.  At bf16
    with more than one head split, the splits' f32 partial dK and dV go to
    a workspace allocated here.  Equal widths only."""
    b, hq, hkv, sq, skv, d, _ = _check(q, k, v, backward=True)
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
