"""Public op: the RWKV6 recurrence from a zero state in the reference
kernel's (B, H, T, hd) shape, computed in f32: r, k, v float32 or bfloat16
and w float32, any strides with the head width contiguous (the model passes
its (B, T, H, hd) projections as views), u (H, hd).  On CUDA tensors it
launches the kernel (which reads the operands where they lie and writes the
output in r's layout) or raises; on CPU tensors it runs the plain PyTorch
version, which autograd differentiates.

On CUDA tensors under autograd (grad mode on and an input that requires
grad) the op is :class:`Rwkv6Scan`: its forward launches K6, its backward
launches K6's backward kernel on the saved operands.  Without autograd the
forward launch is the one serving has always made.

On meta tensors (the dry run) the op computes nothing: it returns an empty
f32 output in r's shape and charges K6's launch to the roofline's count;
under autograd :class:`MetaRwkv6Scan`'s backward charges K6's backward
and returns empty gradients."""
import torch

from ...roofline.trace_analysis import charge
from .kernel import rwkv6_scan_bwd_cuda, rwkv6_scan_cuda
from .ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref


class Rwkv6Scan(torch.autograd.Function):
    """The scan with its backward: on CUDA tensors the two kernels, on CPU
    tensors the two plain versions (as ``gradcheck`` takes them)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        if r.is_cuda:
            return rwkv6_scan_cuda(r, k, v, w, u)
        return rwkv6_scan_ref(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dout):
        r, k, v, w, u = ctx.saved_tensors
        if r.is_cuda:
            if (dout.dtype != torch.float32 or dout.stride(-1) != 1 or dout.data_ptr() % 16
                    or any(st % 4 for st in dout.stride()[:-1])):
                dout = dout.float().contiguous()  # the kernel's 16-byte aligned rows
            return rwkv6_scan_bwd_cuda(r, k, v, w, u, dout)
        grads = rwkv6_scan_bwd_ref(r, k, v, w, u, dout)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (r, k, v, w, u)))


def _shape(r):
    b, h, t, hd = r.shape
    return dict(b=b, h=h, t=t, hd=hd, dtype=r.dtype)


class MetaRwkv6Scan(torch.autograd.Function):
    """K6 and its backward on meta tensors."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        charge("rwkv6_scan", **_shape(r))
        return r.new_empty(r.shape, dtype=torch.float32)

    @staticmethod
    def backward(ctx, dout):
        xs = ctx.saved_tensors
        charge("rwkv6_scan_bwd", **_shape(xs[0]))
        return tuple(x.new_empty(x.shape) for x in xs)


def rwkv6_scan(r, k, v, w, u):
    if r.is_meta:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
            return MetaRwkv6Scan.apply(r, k, v, w, u)
        charge("rwkv6_scan", **_shape(r))
        return r.new_empty(r.shape, dtype=torch.float32)
    if r.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
            return Rwkv6Scan.apply(r, k, v, w, u)
        return rwkv6_scan_cuda(r, k, v, w, u)
    return rwkv6_scan_ref(r, k, v, w, u)
