"""Public op: the RG-LRU recurrence from zero in the reference kernel's
layout, a and g (B, T, R), computed in f32.  On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs the plain PyTorch version, which
autograd differentiates.

On CUDA tensors under autograd (grad mode on and an input that requires
grad) the op is :class:`RgLruScan`: its forward launches K7 and saves its
output, its backward launches K7's backward kernel.  Without autograd the
forward launch is the one serving has always made.

On meta tensors (the dry run) the op computes nothing: it returns an empty
f32 output and charges K7's launch to the roofline's count; under autograd
:class:`MetaRgLruScan`'s backward charges K7's backward and returns empty
gradients."""
import torch

from ...roofline.trace_analysis import charge
from .kernel import rglru_scan_bwd_cuda, rglru_scan_cuda
from .ref import rglru_scan_bwd_ref, rglru_scan_ref


class RgLruScan(torch.autograd.Function):
    """The scan with its backward: on CUDA tensors the two kernels, on CPU
    tensors the two plain versions (as ``gradcheck`` takes them)."""

    @staticmethod
    def forward(ctx, a, g):
        h = rglru_scan_cuda(a, g) if a.is_cuda else rglru_scan_ref(a, g)
        ctx.save_for_backward(a, h)
        ctx.g_dtype = g.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        if a.is_cuda:
            return rglru_scan_bwd_cuda(a, h, dh.float().contiguous())
        da, dg = rglru_scan_bwd_ref(a, h, dh)
        return da.to(a.dtype), dg.to(ctx.g_dtype)


class MetaRgLruScan(torch.autograd.Function):
    """K7 and its backward on meta tensors."""

    @staticmethod
    def forward(ctx, a, g):
        charge("rglru_scan", b=a.shape[0], t=a.shape[1], r=a.shape[2])
        h = a.new_empty(a.shape, dtype=torch.float32)
        ctx.save_for_backward(a, h)
        ctx.g_shape = g.shape
        return h

    @staticmethod
    def backward(ctx, dh):
        a, _ = ctx.saved_tensors
        charge("rglru_scan_bwd", b=a.shape[0], t=a.shape[1], r=a.shape[2])
        return a.new_empty(a.shape), a.new_empty(ctx.g_shape, dtype=torch.float32)


def rglru_scan(a, g):
    if a.is_meta:
        if torch.is_grad_enabled() and (a.requires_grad or g.requires_grad):
            return MetaRgLruScan.apply(a, g)
        charge("rglru_scan", b=a.shape[0], t=a.shape[1], r=a.shape[2])
        return a.new_empty(a.shape, dtype=torch.float32)
    if a.is_cuda:
        a, g = a.float().contiguous(), g.float().contiguous()
        if torch.is_grad_enabled() and (a.requires_grad or g.requires_grad):
            return RgLruScan.apply(a, g)
        return rglru_scan_cuda(a, g)
    return rglru_scan_ref(a, g)
