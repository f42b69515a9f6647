"""Public op: fused similarity histogram with numpy in/out for the core
stratifier.  Pads inputs to block multiples; on a CUDA device it launches
the kernel or raises, on the CPU it runs the plain PyTorch version.  The
optional ``scale`` vector (per-left-row multiplier, e.g. chain-prefix
weights) turns the pair histogram into a chain weight histogram — see
``repro_torch.core.stratify``."""
import numpy as np
import torch

from ...device import resolve_device
from ..padding import pad_rows, remove_pad_counts
from ..sim_sweep.kernel import kernel_operand
from ..sim_sweep.ops import _pow2_block
from .kernel import sim_hist_cuda
from .ref import sim_hist_ref


def sim_hist(e1, e2, n_bins=4096, exponent=1.0, floor=1e-3, block=256,
             scale=None, device="cuda"):
    """Returns (counts[n_bins], edges[n_bins+1]); histogram of (optionally
    row-scaled) pair weights.

    Padded left rows get scale 0 (weight 0 -> bin 0); padded right columns
    pair with real rows at weight ``scale_i * floor**exponent``.  Both
    contributions are computed exactly on the host and subtracted
    (``repro_torch.kernels.padding`` — shared with ``sim_sweep`` so the two
    stay bit-identical).
    """
    dev = resolve_device(device)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n1, n2 = e1.shape[0], e2.shape[0]
    bm, bn = _pow2_block(block, n1), _pow2_block(block, n2)
    e1p, p1 = pad_rows(e1, bm)
    e2p, p2 = pad_rows(e2, bn)
    s = np.ones(n1, np.float32) if scale is None else np.asarray(scale, np.float32)
    sp = np.concatenate([s, np.zeros(p1, np.float32)]) if p1 else s
    a = torch.from_numpy(e1p).to(dev)
    b = torch.from_numpy(e2p).to(dev)
    sp_t = torch.from_numpy(sp).to(dev)
    if dev.type == "cuda":
        counts = sim_hist_cuda(kernel_operand(a, "fp32"),
                               kernel_operand(b, "fp32"), sp_t, n_bins=n_bins,
                               exponent=exponent, floor=floor)
    else:
        counts = sim_hist_ref(a, b, sp_t, n_bins=n_bins, exponent=exponent,
                              floor=floor)
    counts = counts.cpu().numpy().astype(np.int64)
    # remove padded-pair contributions (one global "block": bm >= n1)
    remove_pad_counts(counts.reshape(1, -1), s, p1, p2, e2p.shape[0], n_bins,
                      exponent, floor, bm=max(n1, 1))
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    return counts, edges
