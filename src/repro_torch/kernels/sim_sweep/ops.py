"""Public op: fused single-sweep stratification pass with numpy in/out.

One blocked pass over ``E1 @ E2^T`` yields everything the streaming
stratifier needs: the global weight histogram (exact integer column sum of
the per-block tiles), per-(row-block, bin) count tiles for targeted rescans,
the per-left-row top-k similar right rows for blocking-regime collection,
and compensated per-row walk sums (the wandering-join proposal normaliser —
see ``repro_torch.core.bas_streaming``).  Padding corrections for the counts
are the shared ``repro_torch.kernels.padding`` helpers (the same ones
``sim_hist`` applies, so the fp32 sweep stays bit-identical to the two-kernel
path); the walk sums need none because the backward vector is zero in
padded columns.

``precision`` selects the compute path: ``"fp32"`` (default, bit-identical
to the sim_hist + sim_topk pair), ``"bf16"`` (inputs rounded to bf16, f32
accumulation), or ``"int8"`` (per-row symmetric quantisation via
``repro_torch.core.similarity.quantize_rows_int8``, int32 accumulation).

Device rule: the op runs where its tensors lie.  On a CUDA device it
launches the kernel (``kernel.py``) or raises; on the CPU it runs the plain
PyTorch version (``ref.py``).

Chain callers sweep many left blocks against one fixed right table: build a
:class:`PreparedRight` once with :func:`prepare_right` and pass it as
``right=`` so padding, quantisation and the upload of the right side happen
once, not per prefix block; the padded table stays resident on the device.

Block shapes are the reference's power-of-two defaults (``block=256``).

Spans (``repro_torch.obs.telemetry``): ``joinml.sweep.upload`` (padding and
copying both tables to the device), ``joinml.sweep.kernel`` (the launch) and
``joinml.sweep.readback`` (the copies back, which wait for the kernel).
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...device import host_f32, resolve_device
from ...obs.telemetry import span
from ..padding import pad_rows, remove_pad_counts
from .kernel import kernel_operand, sim_sweep_cuda
from .ref import sim_sweep_ref

PRECISIONS = ("fp32", "bf16", "int8")


def _pow2_block(block, n):
    return min(block, max(8, 1 << (n - 1).bit_length()))


class PreparedRight(NamedTuple):
    """Right table, padded (and quantised for int8) once for many sweeps and
    kept on its device."""

    n2: int
    bn: int
    p2: int
    precision: str
    device: torch.device
    e2p: torch.Tensor              # padded f32 embeddings
    q2: Optional[torch.Tensor]     # int8 path only: quantised rows
    rs2: Optional[torch.Tensor]    # int8 path only: row scales (f32)
    e2k: Optional[torch.Tensor]    # CUDA only: the operand in kernel form


class SweepOut(NamedTuple):
    counts: np.ndarray        # (n_bins,) int64, padding-corrected
    edges: np.ndarray         # (n_bins + 1,) bin edges over [0, 1]
    block_counts: np.ndarray  # (ceil(n1/block_rows), n_bins) int64
    block_rows: int           # left rows per count tile
    vals: np.ndarray          # (n1, k) f32 clipped top-k scores
    idx: np.ndarray           # (n1, k) i32 right-row indices
    valid: np.ndarray         # (n1, k) bool — False for padded-column hits
    row_sums: np.ndarray      # (n1,) f64 compensated walk sums


def prepare_right(e2, block=256, precision="fp32", device="cuda") -> PreparedRight:
    assert precision in PRECISIONS, precision
    dev = resolve_device(device)
    e2 = host_f32(e2)
    n2 = e2.shape[0]
    bn = _pow2_block(block, n2)
    e2p, p2 = pad_rows(e2, bn)
    q2 = rs2 = None
    if precision == "int8":
        from ...core.similarity import quantize_rows_int8

        q2np, rs2np = quantize_rows_int8(e2p)
        q2 = torch.from_numpy(q2np).to(dev)
        rs2 = torch.from_numpy(rs2np.reshape(-1)).to(dev)
    e2p_t = torch.from_numpy(e2p).to(dev)
    e2k = None
    if dev.type == "cuda":
        e2k = kernel_operand(q2 if precision == "int8" else e2p_t, precision)
    return PreparedRight(n2=n2, bn=bn, p2=p2, precision=precision, device=dev,
                         e2p=e2p_t, q2=q2, rs2=rs2, e2k=e2k)


def sim_sweep(e1, e2=None, n_bins=4096, exponent=1.0, floor=1e-3, k=8,
              block=256, scale=None, precision="fp32",
              right: Optional[PreparedRight] = None, back_v=None,
              rs_exponent=None, device="cuda") -> SweepOut:
    """``back_v`` (optional, (n2,) f32) is the backward chain vector applied
    inside the walk sums; ``rs_exponent`` (optional) overrides the weight
    power for the sums only (chain sweeps bin at ``exponent * root`` but
    need the raw full-exponent edge weight in the walk sums).  With
    ``right=`` the sweep runs on the prepared table's device."""
    assert precision in PRECISIONS, precision
    with span("joinml.sweep.upload"):
        e1 = host_f32(e1)
        n1 = e1.shape[0]
        if right is None:
            assert e2 is not None, "pass e2 or a PreparedRight"
            right = prepare_right(e2, block, precision, device=device)
        assert right.precision == precision, (right.precision, precision)
        dev = right.device
        n2 = right.n2
        bm = _pow2_block(block, n1)
        e1p, p1 = pad_rows(e1, bm)
        s = np.ones(n1, np.float32) if scale is None else np.asarray(scale, np.float32)
        sp = np.concatenate([s, np.zeros(p1, np.float32)]) if p1 else s
        # backward vector, zero-padded so padded right columns drop out of the
        # walk sums with no host-side correction
        vp = np.zeros(right.e2p.shape[0], np.float32)
        vp[:n2] = 1.0 if back_v is None else np.asarray(back_v, np.float32)
        sp_t = torch.from_numpy(sp).to(dev)
        vp_t = torch.from_numpy(vp).to(dev)
        rs1 = None
        if precision == "int8":
            from ...core.similarity import quantize_rows_int8

            q1np, rs1np = quantize_rows_int8(e1p)
            a = torch.from_numpy(q1np).to(dev)
            rs1 = torch.from_numpy(rs1np.reshape(-1)).to(dev)
            b = right.q2
        else:
            a = torch.from_numpy(e1p).to(dev)
            b = right.e2p
    kk = min(k, right.bn)
    common = dict(n_bins=n_bins, exponent=exponent, rs_exponent=rs_exponent,
                  floor=floor, k=kk, bm=bm, precision=precision)
    with span("joinml.sweep.kernel"):
        if dev.type == "cuda":
            bc, vals, idx, rs = sim_sweep_cuda(
                kernel_operand(a, precision), right.e2k, sp_t, vp_t, rs1=rs1,
                rs2=right.rs2, **common,
            )
        else:
            bc, vals, idx, rs = sim_sweep_ref(a, b, sp_t, vp_t, rs1=rs1,
                                              rs2=right.rs2, **common)
    with span("joinml.sweep.readback"):
        bc, vals, idx, rs = bc.cpu(), vals.cpu(), idx.cpu(), rs.cpu()
    bc = bc.numpy().astype(np.int64)
    remove_pad_counts(bc, s, p1, right.p2, right.e2p.shape[0], n_bins,
                      exponent, floor, bm)
    counts = bc.sum(axis=0)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    vals = vals.numpy()[:n1]
    idx = idx.numpy()[:n1]
    row_sums = rs.numpy()[:n1].astype(np.float64)
    return SweepOut(
        counts=counts, edges=edges, block_counts=bc, block_rows=bm,
        vals=vals, idx=idx, valid=idx < n2, row_sums=row_sums,
    )
