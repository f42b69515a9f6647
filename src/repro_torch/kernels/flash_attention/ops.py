"""Public op: GQA flash attention in the reference kernel's layout, q (B,
Hq, Sq, d), k and v (B, Hkv, Skv, d); v and the output may be narrower
than q and k (latent attention), where no gradient is taken on a card.  On
CUDA tensors it launches the kernel or raises; on CPU tensors it runs the
plain PyTorch version, which autograd differentiates.

On CUDA tensors under autograd (grad mode on and an input that requires
grad) the op is :class:`FlashAttention`: its forward launches K5 with the
row log-sum-exp saved, its backward launches K5's backward kernel, so no
gradient stops at the ctypes launch.  Without autograd the forward launch
is the one serving has always made."""
import torch

from ...roofline.trace_analysis import charge
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import flash_attention_ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do.contiguous(), lse,
                                              causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _shape(q, k, v, causal, window):
    b, hq, sq, d = q.shape
    out = dict(b=b, hq=hq, hkv=k.shape[1], sq=sq, skv=k.shape[2], d=d, causal=causal,
               window=window, dtype=q.dtype)
    if v.shape[-1] != d:
        out["dv"] = v.shape[-1]
    return out


class MetaFlashAttention(torch.autograd.Function):
    """K5 and its backward on meta tensors: what they would launch, and the
    tensors they would make and keep."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        charge("flash_attention", **_shape(q, k, v, causal, window))
        o = q.new_empty(q.shape)
        ctx.save_for_backward(q, k, v, o, q.new_empty(q.shape[:3], dtype=torch.float32))
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, _ = ctx.saved_tensors
        charge("flash_attention_bwd", **_shape(q, k, v, ctx.causal, ctx.window))
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape), None, None


def flash_attention(q, k, v, causal=True, window=0):
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if grad and (q.is_meta or q.is_cuda) and v.shape[-1] != q.shape[-1]:
        raise ValueError("K5's backward takes equal q/k and v widths")
    if q.is_meta:
        if grad:
            return MetaFlashAttention.apply(q, k, v, causal, window)
        charge("flash_attention", **_shape(q, k, v, causal, window))
        return q.new_empty(q.shape[:-1] + (v.shape[-1],))
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if grad:
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
