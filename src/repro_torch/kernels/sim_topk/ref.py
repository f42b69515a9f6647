"""Plain PyTorch version of sim_topk (see ``kernels/plain.py``)."""
from ..plain import sweep_plain


def sim_topk_ref(e1, e2, k=8):
    """(vals (M, k) f32, idx (M, k) int32) of ``clip(e1 @ e2^T, 0, 1)``,
    descending, ties to the lower column."""
    _, vals, idx, _ = sweep_plain(e1, e2, k=k, hist=False, sums=False)
    return vals, idx
