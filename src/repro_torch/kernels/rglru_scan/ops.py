"""Public op: the RG-LRU recurrence from zero in the reference kernel's
layout, a and g (B, T, R), computed in f32.  On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs the plain PyTorch version."""
from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a, g):
    if a.is_cuda:
        return rglru_scan_cuda(a.float().contiguous(), g.float().contiguous())
    return rglru_scan_ref(a, g)
