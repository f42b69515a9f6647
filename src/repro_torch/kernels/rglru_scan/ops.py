"""Public op: the RG-LRU recurrence from zero in the reference kernel's
layout, a and g (B, T, R), computed in f32.  On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs the plain PyTorch version, which
autograd differentiates.  The kernel has no backward yet (ROADMAP item 15):
on CUDA tensors under autograd the op raises rather than return a result
without a gradient."""
import torch

from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a, g):
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or g.requires_grad):
            raise NotImplementedError(
                "the RG-LRU scan kernel (K7) has no backward yet (ROADMAP item 15); "
                "train recurrentgemma models on the CPU")
        return rglru_scan_cuda(a.float().contiguous(), g.float().contiguous())
    return rglru_scan_ref(a, g)
