"""CUDA launch wrapper of the weight histogram (K4).

Replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/sim_hist/kernel.py``; the kernel is the histogram
epilogue of ``csrc/sim_kernels.cu`` over the same score tile as the sweep
(fp32, or bf16 on the tensor cores), with one count tile spanning every
row."""
from __future__ import annotations

from .. import cuda_lib


def sim_hist_cuda(e1, e2, scale, n_bins=4096, exponent=1.0, floor=1e-3,
                  precision="fp32"):
    """Global (n_bins,) int32 histogram for inputs in kernel form
    (``sim_sweep.kernel.kernel_operand``): f32, or bf16 with
    ``precision="bf16"``."""
    bc, _, _, _ = cuda_lib.launch(
        precision, cuda_lib.HIST, e1, e2, scale=scale, n_bins=n_bins,
        exponent=exponent, floor=floor, bm=max(e1.shape[0], 1),
    )
    cuda_lib.count_launch("sim_hist")
    return bc[0]
