"""Plain PyTorch version of the fused sweep (see ``kernels/plain.py``)."""
from ..plain import sweep_plain


def sim_sweep_ref(e1, e2, scale, v, *, n_bins=4096, exponent=1.0,
                  rs_exponent=None, floor=1e-3, k=8, bm=256,
                  precision="fp32", rs1=None, rs2=None):
    """Same quadruple as :func:`..kernel.sim_sweep_cuda`: (block_counts
    (M/bm, n_bins) int32, vals (M, k) f32, idx (M, k) int32, row_sums (M,)
    f32) over padded inputs.  For int8, ``e1``/``e2`` are the quantised
    rows and ``rs1``/``rs2`` their scales."""
    return sweep_plain(e1, e2, n_bins=n_bins, exponent=exponent, floor=floor,
                       k=k, bm=bm, scale=scale, v=v, rs_exponent=rs_exponent,
                       precision=precision, rs1=rs1, rs2=rs2)
