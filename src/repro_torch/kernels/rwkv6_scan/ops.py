"""Public op: the RWKV6 recurrence from a zero state in the reference
kernel's (B, H, T, hd) shape, computed in f32: r, k, v float32 or bfloat16
and w float32, any strides with the head width contiguous (the model passes
its (B, T, H, hd) projections as views), u (H, hd).  On CUDA tensors it
launches the kernel (which reads the operands where they lie and writes the
output in r's layout) or raises; on CPU tensors it runs the plain PyTorch
version, which autograd differentiates.  The kernel has no backward yet
(ROADMAP item 15): on CUDA tensors under autograd the op raises rather than
return a result without a gradient."""
import torch

from .kernel import rwkv6_scan_cuda
from .ref import rwkv6_scan_ref


def rwkv6_scan(r, k, v, w, u):
    if r.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
            raise NotImplementedError(
                "the RWKV6 scan kernel (K6) has no backward yet (ROADMAP item 15); "
                "train rwkv6 models on the CPU")
        return rwkv6_scan_cuda(r, k, v, w, u)
    return rwkv6_scan_ref(r, k, v, w, u)
