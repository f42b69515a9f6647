"""Plain PyTorch versions of the fused similarity kernels.

One function, :func:`sweep_plain`, computes what ``csrc/sim_kernels.cu``
computes, with the same f32 operations in PyTorch: the score tile, the
weight histogram binned exactly as the kernels bin (f32 ``w * n_bins``
truncated to int32 and clipped — not the f64 ``np.histogram`` of the host
path), the top-k of the clipped score with ties to the lower column, and the
walk sums (accumulated in f64 here, within 1e-6 relative of the kernel's
compensated f32).  The three ``ref.py`` modules are thin wrappers, so the
plain sweep and the plain histogram + top-k pair share one score helper and,
on the same padded shapes, agree bit for bit.

These run whenever the tensors lie on the CPU (the tests), and on the card
only to check the kernels against.
"""
from __future__ import annotations

from typing import Optional

import torch

# rows of E1 scored per matmul; fixed so every plain op sees the same
# operand shapes (and so the same bits) for the same padded inputs
ROW_CHUNK = 1024


def scores_plain(e1: torch.Tensor, e2: torch.Tensor, precision: str = "fp32",
                 rs1: Optional[torch.Tensor] = None,
                 rs2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 scores of one row chunk.  fp32: f32 matmul.  bf16: inputs rounded
    to bf16 (round to nearest even), products and sums in f32.  int8: exact
    integer dot products (through f64, exact below 2**53), then
    ``(float(acc) * rs1_i) * rs2_j`` in f32 in that order."""
    if precision == "int8":
        acc = torch.matmul(e1.double(), e2.double().T).float()
        return (acc * rs1[:, None]) * rs2[None, :]
    if precision == "bf16":
        e1 = e1.to(torch.bfloat16).float()
        e2 = e2.to(torch.bfloat16).float()
    return torch.matmul(e1.float(), e2.float().T)


def _transform(sc: torch.Tensor, floor: float, exponent: float) -> torch.Tensor:
    base = torch.clamp_min(sc, floor)
    return base if exponent == 1.0 else base**exponent


def sweep_plain(e1: torch.Tensor, e2: torch.Tensor, *, n_bins: int = 4096,
                exponent: float = 1.0, floor: float = 1e-3, k: int = 0,
                bm: int = 256, scale: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None,
                rs_exponent: Optional[float] = None, precision: str = "fp32",
                rs1: Optional[torch.Tensor] = None,
                rs2: Optional[torch.Tensor] = None, hist: bool = True,
                sums: bool = True):
    """Returns ``(block_counts (ceil(M/bm), n_bins) int32 | None,
    vals (M, k) f32 | None, idx (M, k) int32 | None, row_sums (M,) f32 |
    None)`` over already padded inputs — the kernel's outputs."""
    m, n = e1.shape[0], e2.shape[0]
    dev = e1.device
    rs_exp = exponent if rs_exponent is None else rs_exponent
    n_tiles = -(-m // bm)
    counts = torch.zeros(n_tiles * n_bins, dtype=torch.int64, device=dev) if hist else None
    vals, idx, row_sums = [], [], []
    for s in range(0, m, ROW_CHUNK):
        stop = min(s + ROW_CHUNK, m)
        sc = torch.clamp(
            scores_plain(e1[s:stop], e2, precision,
                         None if rs1 is None else rs1[s:stop], rs2),
            0.0, 1.0,
        )
        if hist:
            w = _transform(sc, floor, exponent)
            if scale is not None:
                w = w * scale[s:stop, None]
            b = torch.clamp((w * n_bins).to(torch.int32), 0, n_bins - 1)
            tile = torch.arange(s, stop, device=dev) // bm
            flat = (tile[:, None] * n_bins + b).reshape(-1)
            counts += torch.bincount(flat, minlength=n_tiles * n_bins)
        if k:
            sv, si = torch.sort(sc, dim=1, descending=True, stable=True)
            vals.append(sv[:, :k].contiguous())
            idx.append(si[:, :k].to(torch.int32))
        if sums:
            wr = _transform(sc, floor, rs_exp)
            if v is not None:
                wr = wr * v[None, :]
            row_sums.append(wr.double().sum(dim=1).float())
    bc = counts.reshape(n_tiles, n_bins).to(torch.int32) if hist else None
    return (
        bc,
        torch.cat(vals) if k else None,
        torch.cat(idx) if k else None,
        torch.cat(row_sums) if sums else None,
    )
