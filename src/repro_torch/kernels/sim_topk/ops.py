"""Public op: per-left-row top-k similar right rows (NN blocking), numpy in
and out.  On a CUDA device it launches the kernel or raises; on the CPU it
runs the plain PyTorch version."""
import numpy as np
import torch

from ...device import resolve_device
from ..padding import pad_rows
from ..sim_sweep.kernel import kernel_operand
from ..sim_sweep.ops import _pow2_block
from .kernel import sim_topk_cuda
from .ref import sim_topk_ref


def sim_topk(e1, e2, k=8, block=256, device="cuda"):
    dev = resolve_device(device)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n1, n2 = e1.shape[0], e2.shape[0]
    bm, bn = _pow2_block(block, n1), _pow2_block(block, n2)
    e1p, _ = pad_rows(e1, bm)
    e2p, _ = pad_rows(e2, bn)
    a = torch.from_numpy(e1p).to(dev)
    b = torch.from_numpy(e2p).to(dev)
    kk = min(k, bn)
    if dev.type == "cuda":
        vals, idx = sim_topk_cuda(kernel_operand(a, "fp32"),
                                  kernel_operand(b, "fp32"), k=kk)
    else:
        vals, idx = sim_topk_ref(a, b, k=kk)
    vals, idx = vals.cpu().numpy()[:n1], idx.cpu().numpy()[:n1]
    # drop hits pointing at padded right rows (score 0 ties)
    valid = idx < n2
    return vals, idx, valid
