"""Public op: GQA flash attention in the reference kernel's layout, q (B,
Hq, Sq, d), k and v (B, Hkv, Skv, d).  On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs the plain PyTorch version, which
autograd differentiates.

On CUDA tensors under autograd (grad mode on and an input that requires
grad) the op is :class:`FlashAttention`: its forward launches K5 with the
row log-sum-exp saved, its backward launches K5's backward kernel, so no
gradient stops at the ctypes launch.  Without autograd the forward launch
is the one serving has always made."""
import torch

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


def flash_attention(q, k, v, causal=True, window=0):
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
