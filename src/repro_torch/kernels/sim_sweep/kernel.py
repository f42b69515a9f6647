"""CUDA launch wrapper of the fused sweep (K1 at fp32 / bf16, K2 at int8).

Replaces the Pallas kernels ``_kernel`` and ``_kernel_q`` of
``src/repro/kernels/sim_sweep/kernel.py``; the kernel itself is
``csrc/sim_kernels.cu`` (histogram + top-k + walk-sum epilogues)."""
from __future__ import annotations

import torch

from .. import cuda_lib

# launch-count key per precision
NAMES = {"fp32": "sim_sweep[fp32]", "bf16": "sim_sweep[bf16]",
         "int8": "sim_sweep_q[int8]"}


def kernel_operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A padded table in the form the kernel reads: f32, bf16 (rounded to
    nearest even) or int8 rows, the width padded with zero columns to a
    multiple of 16 bytes (``cuda_lib.ALIGN``)."""
    if precision == "bf16":
        t = t.to(torch.bfloat16)
    return cuda_lib.pad_cols(t, cuda_lib.ALIGN[precision])


def sim_sweep_cuda(e1, e2, scale, v, *, n_bins=4096, exponent=1.0,
                   rs_exponent=None, floor=1e-3, k=8, bm=256,
                   precision="fp32", rs1=None, rs2=None, splits=None):
    """One launch over padded inputs already in kernel form
    (:func:`kernel_operand`), split into ``splits`` column ranges (by
    default as ``cuda_lib.launch`` chooses).  Returns (block_counts (M/bm,
    n_bins) int32, vals (M, k) f32, idx (M, k) int32, row_sums (M,) f32).

    Count tiles of fewer rows than a CTA's (``bm`` not a multiple of
    ``cuda_lib.CTA_ROWS``, which index maintenance asks for at an artifact's
    small ``block_rows``) cannot come from one launch: each tile's rows are
    then launched on their own, one launch a tile, and the outputs stacked.
    A score is the same number in any launch (one ``fmaf`` chain in fp32, a
    fixed k-slice order in bf16, an exact integer sum in int8), so tiles and
    top-k equal a single launch's; the walk sums' column split follows the
    row count, so they agree within the 1e-6 contract."""
    m = e1.shape[0]
    if bm % cuda_lib.CTA_ROWS and m > bm:
        parts = [
            sim_sweep_cuda(
                e1[s:s + bm], e2, scale[s:s + bm], v, n_bins=n_bins,
                exponent=exponent, rs_exponent=rs_exponent, floor=floor, k=k,
                bm=bm, precision=precision,
                rs1=None if rs1 is None else rs1[s:s + bm], rs2=rs2,
                splits=splits)
            for s in range(0, m, bm)
        ]
        return tuple(torch.cat(out) for out in zip(*parts))
    rs_exp = exponent if rs_exponent is None else rs_exponent
    out = cuda_lib.launch(
        precision, cuda_lib.HIST | cuda_lib.TOPK | cuda_lib.SUMS, e1, e2,
        rs1=rs1, rs2=rs2, scale=scale, v=v, n_bins=n_bins, exponent=exponent,
        rs_exponent=rs_exp, floor=floor, k=k, bm=bm, splits=splits,
    )
    cuda_lib.count_launch(NAMES[precision])
    return out
