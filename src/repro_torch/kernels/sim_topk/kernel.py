"""CUDA launch wrapper of the per-row top-k (K3).

Replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/sim_topk/kernel.py``; the kernel is the top-k epilogue
of ``csrc/sim_kernels.cu`` over the same score tile as the sweep (fp32, or
bf16 on the tensor cores), or, for a fp32 launch over at most
``cuda_lib.FEW_ROWS`` rows (the raised-k retry), the few-row kernels of the
same file: one pass over E2 for the scores, then a radix select and sort a
row.  Both give the same lists bit for bit."""
from __future__ import annotations

from .. import cuda_lib


def sim_topk_cuda(e1, e2, k=8, precision="fp32"):
    """(vals (M, k) f32, idx (M, k) int32) for inputs in kernel form
    (``sim_sweep.kernel.kernel_operand``): f32, or bf16 with
    ``precision="bf16"``."""
    _, vals, idx, _ = cuda_lib.launch(precision, cuda_lib.TOPK, e1, e2, k=k)
    cuda_lib.count_launch(f"sim_topk[k={k}]")
    return vals, idx
