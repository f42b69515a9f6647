"""CUDA launch wrapper of the weight histogram (K4).

Replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/sim_hist/kernel.py``; the kernel is the histogram
epilogue of ``csrc/sim_kernels.cu`` over the same fp32 score tile as the
sweep, with one count tile spanning every row."""
from __future__ import annotations

from .. import cuda_lib


def sim_hist_cuda(e1, e2, scale, n_bins=4096, exponent=1.0, floor=1e-3):
    """Global (n_bins,) int32 histogram for f32 inputs with the width padded
    to a multiple of 4."""
    bc, _, _, _ = cuda_lib.launch(
        "fp32", cuda_lib.HIST, e1, e2, scale=scale, n_bins=n_bins,
        exponent=exponent, floor=floor, bm=max(e1.shape[0], 1),
    )
    cuda_lib.LAUNCHES["sim_hist"] += 1
    return bc[0]
