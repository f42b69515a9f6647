"""Plain PyTorch version of sim_hist (see ``kernels/plain.py``)."""
from ..plain import sweep_plain


def sim_hist_ref(e1, e2, scale, n_bins=4096, exponent=1.0, floor=1e-3):
    """Global (n_bins,) int32 histogram of
    ``max(clip(e1 @ e2^T, 0, 1), floor)**exponent * scale_i``."""
    bc, _, _, _ = sweep_plain(e1, e2, n_bins=n_bins, exponent=exponent,
                              floor=floor, bm=max(e1.shape[0], 1),
                              scale=scale, sums=False)
    return bc[0]
