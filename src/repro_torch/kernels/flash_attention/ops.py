"""Public op: GQA flash attention in the reference kernel's layout, q (B,
Hq, Sq, d), k and v (B, Hkv, Skv, d).  On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs the plain PyTorch version."""
from .kernel import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q, k, v, causal=True, window=0):
    if q.is_cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
