"""Public op: the RWKV6 recurrence from a zero state in the reference
kernel's layout, r, k, v, w (B, H, T, hd) and u (H, hd), computed in f32.
On CUDA tensors it launches the kernel or raises; on CPU tensors it runs the
plain PyTorch version."""
from .kernel import rwkv6_scan_cuda
from .ref import rwkv6_scan_ref


def rwkv6_scan(r, k, v, w, u):
    if r.is_cuda:
        r, k, v, w, u = (x.float().contiguous() for x in (r, k, v, w, u))
        return rwkv6_scan_cuda(r, k, v, w, u)
    return rwkv6_scan_ref(r, k, v, w, u)
