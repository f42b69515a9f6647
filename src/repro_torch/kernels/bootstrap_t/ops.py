"""Public op: the bootstrap-t's per-resample moments over the usable
strata, numpy in and out, drawing from a numpy Generator and leaving it in
the state ``Generator.integers`` would.  On a CUDA device it launches the
kernels or raises; on the CPU it runs the plain NumPy version."""
from __future__ import annotations

import numpy as np

from ...device import resolve_device
from .kernel import resample_moments_cuda
from .ref import resample_moments_ref


def resample_moments(sum_terms, count_terms, n_boot: int, rng: np.random.Generator,
                     flags: int, device="cuda") -> tuple:
    """``((5, n_boot) f64, rejections)``: rows ``sum_shift``, ``cnt_shift``,
    ``var_sum``, ``var_cnt``, ``cov_sc`` of ``core.bootstrap`` (the rows
    ``flags`` does not ask for are 0) over the strata whose stratum-centred
    terms ``sum_terms`` / ``count_terms`` hold (lists of f64 arrays, in
    stratum order; None where ``flags`` does not read them), drawn as
    ``rng.integers(0, n_i, size=(n_boot, n_i))`` stratum after stratum."""
    dev = resolve_device(device)
    state = rng.bit_generator.state
    if dev.type == "cuda":
        out, after, n_rej = resample_moments_cuda(sum_terms, count_terms, n_boot, state,
                                                  flags, dev)
    else:
        out, after, n_rej = resample_moments_ref(sum_terms, count_terms, n_boot, state,
                                                 flags)
    rng.bit_generator.state = after
    return out, n_rej
