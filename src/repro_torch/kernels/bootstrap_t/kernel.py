"""CUDA launch wrapper of the bootstrap-t's resampling (K8).

Replaces no Pallas kernel: the reference draws the resample indices with
numpy's Generator and reduces them on the host
(``src/repro/core/bootstrap.py``).  The kernels are ``boot_detect_kernel``,
``boot_moments_kernel`` and ``boot_reduce_kernel`` in
``csrc/bootstrap_kernels.cu`` (its header gives the design and the bound).

One call takes two round trips on a CUDA stream of the calling thread's own,
and synchronises only that stream, so concurrent queries on other threads
never wait behind each other's work on the default stream: the terms and
the LCG's jump table go up through pinned staging, the detecting kernel's
rejected words come back, the host walks them
(``plain.resolve_rejections``), the rejected draws go up, and 5 x n_boot
f64 come back."""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import cuda_lib, plain

DETECT_RUN = 64   # words a detecting thread tests (DETECT_RUN in the source)
_ALIGN = 16

_local = threading.local()


class _Staging:
    """A thread's own stream on one device, and its pinned host buffers for
    the copies up and down, grown as calls need.  Every call ends by
    synchronising the stream, so the next may write the buffers again."""

    def __init__(self, dev: torch.device):
        self.stream = torch.cuda.Stream(dev)
        self._bufs: dict[str, torch.Tensor] = {}

    def host(self, which: str, nbytes: int) -> torch.Tensor:
        buf = self._bufs.get(which)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8, pin_memory=True)
            self._bufs[which] = buf
        return buf


def _staging(dev: torch.device) -> _Staging:
    per = getattr(_local, "staging", None)
    if per is None:
        per = _local.staging = {}
    st = per.get(dev.index)
    if st is None:
        st = per[dev.index] = _Staging(dev)
    return st


def _upload(stage: _Staging, dev: torch.device, arrays: list) -> tuple:
    """Copy ``arrays`` (numpy) up in one copy from the pinned buffer, each
    at a 16-byte aligned offset; returns the device buffer (keep it while
    the kernels run) and each array's device address."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    host = stage.host("up", total)
    flat = host.numpy()
    for a, o in zip(arrays, offs):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev_buf = torch.empty(max(total, _ALIGN), dtype=torch.uint8, device=dev)
    dev_buf[:total].copy_(host[:total], non_blocking=True)
    base = dev_buf.data_ptr()
    return dev_buf, [base + o for o in offs]


def _download(stage: _Staging, t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes on the host once the stream has run up to here."""
    nbytes = t.numel() * t.element_size()
    host = stage.host("down", nbytes)[:nbytes]
    host.copy_(t.reshape(-1).view(torch.uint8), non_blocking=True)
    stage.stream.synchronize()
    return host.numpy().copy()


def _vp(addr: int) -> ctypes.c_void_p:
    return ctypes.c_void_p(addr)


def resample_moments_cuda(sum_terms, count_terms, n_boot: int, state: dict, flags: int,
                          dev: torch.device) -> tuple:
    """What :func:`repro_torch.kernels.plain.resample_moments_plain`
    computes, on the card: ``((5, n_boot) f64, the Generator's state after,
    rejections)``."""
    s0, inc, h, buf = plain.pcg64_state(state)
    use_s, use_c = bool(flags & plain.MOMENT_SUM), bool(flags & plain.MOMENT_COUNT)
    terms = sum_terms if use_s else count_terms
    highs = np.array([len(t) for t in terms], np.int64)
    n_strata = len(highs)
    if n_boot <= 0 or n_strata == 0:
        raise ValueError("the bootstrap needs resamples and strata")
    counts = n_boot * highs
    thr = plain.lemire_thresholds(highs).astype(np.uint32)
    ends = np.cumsum(counts)
    starts = ends - counts
    toff = np.concatenate([[0], np.cumsum(highs)[:-1]]).astype(np.int64)
    empty = np.zeros(0)
    xs = np.concatenate(sum_terms).astype(np.float64) if use_s else empty
    xc = np.concatenate(count_terms).astype(np.float64) if use_c else empty
    tab = plain.pcg64_jump_table(inc)
    gen = (ctypes.c_uint64(s0 & 0xFFFFFFFFFFFFFFFF), ctypes.c_uint64(s0 >> 64),
           ctypes.c_uint64(inc & 0xFFFFFFFFFFFFFFFF), ctypes.c_uint64(inc >> 64),
           h, ctypes.c_uint(buf))
    slack = plain.rejection_slack(highs, counts)
    cap = 1024 + 4 * slack
    stage = _staging(dev)
    so = cuda_lib.lib()
    stream = ctypes.c_void_p(stage.stream.cuda_stream)
    with torch.cuda.device(dev), torch.cuda.stream(stage.stream):
        while True:
            wcount = np.where(thr > 0, counts + slack, 0).astype(np.int64)
            run_prefix = np.concatenate(
                [[0], np.cumsum(-(-wcount // DETECT_RUN))]).astype(np.int64)
            held, (p_tab, p_start, p_wcount, p_high, p_thr, p_runs, p_toff, p_xs, p_xc) = \
                _upload(stage, dev, [tab, starts, wcount, highs.astype(np.uint32), thr,
                                     run_prefix, toff, xs, xc])
            scratch = torch.empty(_ALIGN + 12 * cap, dtype=torch.uint8, device=dev)
            p_n = scratch.data_ptr()
            p_cw, p_cs = p_n + _ALIGN, p_n + _ALIGN + 8 * cap
            err = so.repro_boot_detect(
                _vp(p_tab), *gen, n_strata, _vp(p_start), _vp(p_wcount), _vp(p_high),
                _vp(p_thr), _vp(p_runs), int(run_prefix[-1]), cap, _vp(p_cw), _vp(p_cs),
                _vp(p_n), stream)
            if err != 0:
                raise RuntimeError(f"repro_boot_detect failed with CUDA error {err}")
            if run_prefix[-1]:
                cuda_lib.count_launch("bootstrap_detect")
            got = _download(stage, scratch)
            n_cand = int(got[:4].view(np.int32)[0])
            if n_cand > cap:
                cap = 2 * n_cand
                continue
            cand_w = got[_ALIGN:_ALIGN + 8 * n_cand].view(np.int64)
            cand_s = got[_ALIGN + 8 * cap:_ALIGN + 8 * cap + 4 * n_cand].view(np.int32)
            rej = plain.resolve_rejections(cand_w, cand_s, ends)
            if len(rej) <= slack:
                break
            slack = 2 * len(rej)
        held_rej, (p_rej,) = _upload(stage, dev, [rej])
        arrays = int(use_s) + int(use_c)
        need = highs * 8 * arrays
        fit = need[need <= cuda_lib.MAX_SMEM]
        smem = int(fit.max()) if len(fit) else 0
        part = torch.empty((n_strata, 5, n_boot), dtype=torch.float64, device=dev)
        out = torch.zeros((5, n_boot), dtype=torch.float64, device=dev)
        err = so.repro_boot_moments(
            _vp(p_tab), *gen, n_strata, n_boot, _vp(p_start), _vp(p_high), _vp(p_toff),
            _vp(p_xs), _vp(p_xc), flags, _vp(p_rej), len(rej), smem,
            _vp(part.data_ptr()), _vp(out.data_ptr()), stream)
        if err != 0:
            raise RuntimeError(f"repro_boot_moments failed with CUDA error {err}")
        cuda_lib.count_launch("bootstrap_moments")
        cuda_lib.count_launch("bootstrap_reduce")
        moments = _download(stage, out).view(np.float64).reshape(5, n_boot)
        del held, held_rej
    words = int(ends[-1]) + len(rej)
    return moments, plain.state_after(state, words), len(rej)
