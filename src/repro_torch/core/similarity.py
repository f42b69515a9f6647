"""Embedding similarity and sampling weights (paper §2, §5.1).

The blocked similarity products run in PyTorch on the chosen device; the
outputs the statistical layer needs (weight vectors, sums) are returned as
float64 numpy for numerically robust aggregation, exactly as in the
reference package.

Weight convention: embeddings are unit-normalised, so ``E1 @ E2.T`` is the
cosine similarity.  The paper treats similarity as an (approximate) match
probability, so we map it to a strictly positive weight::

    w = max(clip(cos, 0, 1), floor) ** exponent

The floor keeps every tuple reachable (a zero sampling probability would break
unbiasedness for false negatives — the exact failure mode of blocking the
paper is fixing); the exponent reproduces the Fig. 13b sensitivity knob.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import host_f32, resolve_device


def normalize(emb: np.ndarray) -> np.ndarray:
    emb = np.asarray(emb, dtype=np.float32)
    norm = np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb / np.maximum(norm, 1e-12)


def as_f32_tensor(x, device: torch.device) -> torch.Tensor:
    """numpy / tensor -> contiguous float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(host_f32(x)).to(device)


def weights_of_scores_t(sim: torch.Tensor, exponent: float,
                        floor: float) -> torch.Tensor:
    """f32 score tensor -> f32 sampling weights (the in-framework transform,
    the same f32 operations as the reference's jitted ``_pair_weights_jax``)."""
    w = torch.clamp(sim, 0.0, 1.0)
    w = torch.clamp_min(w, floor)
    if exponent != 1.0:
        w = w**exponent
    return w


def pair_weights_t(e1: torch.Tensor, e2: torch.Tensor, exponent: float,
                   floor: float) -> torch.Tensor:
    """(N1, N2) float32 weights of two f32 tensors on one device."""
    return weights_of_scores_t(torch.matmul(e1, e2.T), exponent, floor)


def pair_weights(
    e1: np.ndarray,
    e2: np.ndarray,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 8192,
    device="cuda",
) -> np.ndarray:
    """(N1, N2) sampling weights as float64 numpy.  Blocked to bound peak
    device memory."""
    dev = resolve_device(device)
    t1 = as_f32_tensor(e1, dev)
    t2 = as_f32_tensor(e2, dev)
    n1 = t1.shape[0]
    if n1 <= block:
        return pair_weights_t(t1, t2, exponent, floor).double().cpu().numpy()
    out = np.empty((n1, t2.shape[0]), np.float64)
    for s in range(0, n1, block):
        out[s : s + block] = (
            pair_weights_t(t1[s : s + block], t2, exponent, floor)
            .double().cpu().numpy()
        )
    return out


def chain_weights(
    embeddings: list[np.ndarray],
    exponent: float = 1.0,
    floor: float = 1e-3,
    device="cuda",
) -> np.ndarray:
    """Flattened (N1*...*Nk,) weights: product of consecutive pair weights.

    Paper Alg. 2 line 4: W(t) = prod_j sim(E(t_j), E(t_{j+1})).  Dense path —
    only used when the cross product fits in memory; the streaming/NN path in
    ``stratify.py`` covers the rest.
    """
    sizes = [e.shape[0] for e in embeddings]
    w = np.ones((1,), np.float64)
    # w has shape (prod(sizes[:i+1]),) after step i
    for i in range(len(embeddings) - 1):
        pw = pair_weights(embeddings[i], embeddings[i + 1], exponent, floor,
                          device=device)
        if i == 0:
            w = pw.reshape(-1)
        else:
            # w: (prod(sizes[:i+1]),) indexed by (..., t_i); extend with t_{i+1}
            w = (w.reshape(-1, sizes[i])[:, :, None] * pw[None, :, :]).reshape(-1)
    return w


def quantize_rows_int8(emb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantisation: ``emb ~= q * row_scale``.

    Used by the ``sim_sweep`` int8 path — scores reconstruct as
    ``(q1 @ q2^T) * rs1_i * rs2_j`` with exact int32 accumulation, so the
    only error is the per-element rounding of the embeddings themselves
    (<= 0.5 * row_scale, i.e. ~0.4% of the row absmax).  All-zero rows
    (e.g. block padding) quantise to zeros with scale 0.
    """
    emb = np.asarray(emb, np.float32)
    absmax = np.abs(emb).max(axis=1, keepdims=True)
    row_scale = absmax / 127.0
    q = np.where(
        absmax > 0, np.rint(emb / np.maximum(row_scale, 1e-30)), 0.0
    ).astype(np.int8)
    return q, row_scale.astype(np.float32)


def dequantize_rows_int8(q: np.ndarray, row_scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_rows_int8` (up to rounding)."""
    return q.astype(np.float32) * np.asarray(row_scale, np.float32).reshape(-1, 1)


def weight_of_score(
    s: np.ndarray, exponent: float = 1.0, floor: float = 1e-3
) -> np.ndarray:
    """The score -> sampling-weight transform (single source of truth —
    stratification thresholds and sampling probabilities must agree)."""
    w = np.clip(s, 0.0, 1.0)
    w = np.maximum(w, floor)
    return w**exponent if exponent != 1.0 else w


def aligned_pair_weights(
    e1: np.ndarray,
    e2: np.ndarray,
    i: np.ndarray,
    j: np.ndarray,
    exponent: float = 1.0,
    floor: float = 1e-3,
) -> np.ndarray:
    """Elementwise weights for aligned index vectors (no cross block)."""
    sims = np.einsum("nd,nd->n", e1[i].astype(np.float64), e2[j].astype(np.float64))
    return weight_of_score(sims, exponent, floor)


def chain_tuple_weights(
    embeddings: list,
    idx: np.ndarray,
    exponent: float = 1.0,
    floor: float = 1e-3,
) -> np.ndarray:
    """Chain weights W(t) = prod_j w_j(t_j, t_{j+1}) for explicit (n, k)
    tuples — O(n * k * d), never touches the cross product."""
    idx = np.asarray(idx)
    w = np.ones(idx.shape[0], np.float64)
    for j in range(len(embeddings) - 1):
        w *= aligned_pair_weights(
            embeddings[j], embeddings[j + 1], idx[:, j], idx[:, j + 1],
            exponent, floor,
        )
    return w


# Pass accounting for the standalone walk-statistic recomputations below.
# The fused sweep (repro_torch.core.stratify.sweep_pass*) emits row sums and
# the chain total in the same blocked pass as the histogram, so a streaming
# query that goes through the sweep should never land here; tests and the
# chip smoke assert these counters stay flat on that path.
PASS_COUNTS: dict[str, int] = {"edge_row_sums": 0, "chain_total_weight": 0}


def _reduce_rows(e1, e2, exponent, floor, device, v=None) -> np.ndarray:
    """Row sums (or, with ``v``, the matrix-vector product) of one block of
    f64 pair weights, reduced on the device so only (rows,) crosses."""
    dev = resolve_device(device)
    w = pair_weights_t(as_f32_tensor(e1, dev), as_f32_tensor(e2, dev),
                       exponent, floor).double()
    out = w.sum(dim=1) if v is None else w @ torch.from_numpy(v).to(dev)
    return out.cpu().numpy()


def edge_row_sums_raw(
    embeddings: list,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    device="cuda",
) -> list:
    """:func:`edge_row_sums` without the pass accounting — for internal
    callers (the fused sweep) that only touch cheap prefix edges."""
    out = []
    for j in range(len(embeddings) - 1):
        e1, e2 = embeddings[j], embeddings[j + 1]
        r = np.zeros(e1.shape[0], np.float64)
        for s in range(0, e1.shape[0], block):
            r[s : s + block] = _reduce_rows(e1[s : s + block], e2, exponent,
                                            floor, device)
        out.append(r)
    return out


def edge_row_sums(
    embeddings: list,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    device="cuda",
) -> list:
    """Per-edge row sums r_j[i] = sum_t w_j(i, t), streamed in O(block * N)
    memory.  These normalise the WWJ walk distribution p(t) =
    (1/N1) * prod_j w_j(t_j, t_{j+1}) / r_j(t_j)."""
    PASS_COUNTS["edge_row_sums"] += 1
    return edge_row_sums_raw(embeddings, exponent, floor, block, device)


def chain_total_weight(
    embeddings: list,
    exponent: float = 1.0,
    floor: float = 1e-3,
    block: int = 4096,
    device="cuda",
) -> float:
    """sum over the full cross product of prod_j w_j — via the backward
    matrix-vector chain v_j = W_j v_{j+1}, streamed (O(max N) memory)."""
    PASS_COUNTS["chain_total_weight"] += 1
    v = np.ones(embeddings[-1].shape[0], np.float64)
    for j in range(len(embeddings) - 2, -1, -1):
        e1, e2 = embeddings[j], embeddings[j + 1]
        nxt = np.zeros(e1.shape[0], np.float64)
        for s in range(0, e1.shape[0], block):
            nxt[s : s + block] = _reduce_rows(e1[s : s + block], e2,
                                              exponent, floor, device, v)
        v = nxt
    return float(v.sum())


def flat_to_tuples(flat_idx: np.ndarray, sizes: tuple) -> np.ndarray:
    """(n,) flat cross-product indices -> (n, k) per-table indices."""
    return np.stack(np.unravel_index(np.asarray(flat_idx), sizes), axis=1).astype(
        np.int64
    )


def tuples_to_flat(idx: np.ndarray, sizes: tuple) -> np.ndarray:
    return np.ravel_multi_index(tuple(idx[:, j] for j in range(idx.shape[1])), sizes)
