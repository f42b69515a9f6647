"""Plain versions of the port's hand-written query kernels.

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

The bootstrap-t's resamples (K8, ``csrc/bootstrap_kernels.cu``) have a
plain NumPy version at the end: :func:`replay_integers` makes numpy's
``Generator.integers`` draws from the Generator's state by the card's
scheme, and :func:`resample_moments_plain` the moments the card returns.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
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


# ---------------------------------------------------------------------------
# The bootstrap-t's resamples (K8, ``csrc/bootstrap_kernels.cu``): numpy's
# ``Generator.integers`` replayed from the Generator's state, as the card
# makes the draws, and the per-resample moments the card computes.  The
# state's reading, the LCG's jump table, the rejection walk and the state
# handed back are the host's part of the card's path too.
# ---------------------------------------------------------------------------

PCG64_MULT = 0x2360ED051FC65DA44385DF649FCCF645
_U128 = (1 << 128) - 1
_U64 = (1 << 64) - 1
_LO32 = np.uint64(0xFFFFFFFF)


def pcg64_state(state: dict) -> tuple:
    """``(state, inc, has_uint32, uinteger)`` as ints of a PCG64
    ``bit_generator.state``; any other bit generator is refused (its draws
    cannot be replayed)."""
    if state.get("bit_generator") != "PCG64":
        raise ValueError("the resample draws replay numpy's PCG64 (np.random.default_rng), "
                         f"not {state.get('bit_generator')!r}")
    st = state["state"]
    return int(st["state"]), int(st["inc"]), int(state["has_uint32"]), int(state["uinteger"])


@functools.lru_cache(maxsize=16)
def pcg64_jump_table(inc: int) -> np.ndarray:
    """(64, 4) uint64: row b holds (A lo, A hi, C lo, C hi) of 2**b steps
    of the LCG, ``s -> A s + C`` mod 2**128."""
    a, c = PCG64_MULT, inc
    rows = []
    for _ in range(64):
        rows.append((a & _U64, a >> 64, c & _U64, c >> 64))
        a, c = (a * a) & _U128, (a * c + c) & _U128
    table = np.array(rows, dtype=np.uint64)
    table.flags.writeable = False  # shared by every caller of the cache
    return table


def _xsl_rr(s: int) -> int:
    x = (s >> 64) ^ (s & _U64)
    rot = s >> 122
    return ((x >> rot) | (x << ((-rot) & 63))) & _U64


def pcg64_advance(s: int, inc: int, k: int) -> int:
    """The state ``k`` steps after ``s``."""
    table = pcg64_jump_table(inc)
    b = 0
    while k:
        if k & 1:
            a_lo, a_hi, c_lo, c_hi = (int(v) for v in table[b])
            s = (((a_hi << 64) | a_lo) * s + ((c_hi << 64) | c_lo)) & _U128
        k >>= 1
        b += 1
    return s


def state_after(state: dict, words: int) -> dict:
    """The Generator's state once ``words`` 32-bit words have been drawn
    from ``state``: the LCG advanced by the 64-bit outputs taken, and the
    half-word they leave buffered."""
    s, inc, h, u = pcg64_state(state)
    rest = words - 1 if h and words else words
    outputs = (rest + 1) // 2
    if outputs:
        s = pcg64_advance(s, inc, outputs)
        h, u = rest % 2, _xsl_rr(s) >> 32
    elif words:
        h = 0  # only the buffered half-word was taken
    return {"bit_generator": "PCG64", "state": {"state": s, "inc": inc},
            "has_uint32": h, "uinteger": u}


def lemire_thresholds(highs: np.ndarray) -> np.ndarray:
    """``2**32 mod n``: a word u is rejected for range n while
    ``(u * n) mod 2**32`` is under it."""
    highs = np.asarray(highs, np.int64)
    if highs.size and (highs.min() < 2 or highs.max() >= 1 << 32):
        raise ValueError("the replayed ranges lie in [2, 2**32)")
    return ((1 << 32) % highs).astype(np.uint64)


def rejection_slack(highs: np.ndarray, counts: np.ndarray) -> int:
    """Words to test past each stratum's draws: the rejections expected
    over all draws and six deviations more (the walk raises it where it
    runs short)."""
    e = float(np.sum(counts * (lemire_thresholds(highs) / 2.0**32)))
    return int(e + 6.0 * np.sqrt(e)) + 16


def resolve_rejections(cand_w: np.ndarray, cand_s: np.ndarray,
                       ends: np.ndarray) -> np.ndarray:
    """The draws whose word was rejected, in order, once a rejection (a
    draw rejected twice appears twice).  ``(cand_w, cand_s)``: every word
    ``w`` rejected under stratum ``s``'s range, among the words that
    stratum could read; ``ends``: the draw after each stratum's last.  The
    draw that reads word ``w`` is ``w`` less the rejections before it."""
    order = np.lexsort((cand_s, cand_w))
    cw, cs = cand_w[order].tolist(), cand_s[order].tolist()
    total = int(ends[-1]) if len(ends) else 0
    rej: list[int] = []
    i = 0
    while i < len(cw):
        w = cw[i]
        d = w - len(rej)
        if d >= total:
            break
        st = int(np.searchsorted(ends, d, side="right"))
        hit = False
        while i < len(cw) and cw[i] == w:
            hit |= cs[i] == st
            i += 1
        if hit:
            rej.append(d)
    return np.asarray(rej, np.int64)


def _mul_full64(a: np.ndarray, b: np.ndarray) -> tuple:
    """(hi, lo) of the 128-bit products of uint64 arrays."""
    a0, a1, b0, b1 = a & _LO32, a >> np.uint64(32), b & _LO32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & _LO32) + (p10 & _LO32)
    lo = (mid << np.uint64(32)) | (p00 & _LO32)
    hi = p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))
    return hi, lo


def _muladd128(a_hi, a_lo, s_hi, s_lo, c_hi, c_lo) -> tuple:
    """``a * s + c`` mod 2**128 on (hi, lo) uint64 pairs: ``s`` arrays,
    ``a`` and ``c`` scalars."""
    hi, lo = _mul_full64(a_lo, s_lo)
    hi = hi + a_lo * s_hi + a_hi * s_lo
    out_lo = lo + c_lo
    return hi + c_hi + (out_lo < lo).astype(np.uint64), out_lo


def _xsl_rr_np(s_hi: np.ndarray, s_lo: np.ndarray) -> np.ndarray:
    x = s_hi ^ s_lo
    rot = s_hi >> np.uint64(58)
    return (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))


def pcg64_outputs(s: int, inc: int, first: int, count: int, run: int = 64) -> np.ndarray:
    """The 64-bit outputs ``first .. first + count - 1`` after state ``s``
    (output j: XSL-RR of the state j + 1 steps on), as the card makes them:
    each run of ``run`` outputs jumps to its start, then steps."""
    runs = -(-count // run)
    table = pcg64_jump_table(inc)
    steps = first + 1 + run * np.arange(runs, dtype=np.uint64)
    hi = np.full(runs, s >> 64, np.uint64)
    lo = np.full(runs, s & _U64, np.uint64)
    for b in range(64):
        take = ((steps >> np.uint64(b)) & np.uint64(1)).astype(bool)
        if take.any():
            a_lo, a_hi, c_lo, c_hi = table[b]
            hi[take], lo[take] = _muladd128(a_hi, a_lo, hi[take], lo[take], c_hi, c_lo)
    m_hi, m_lo = np.uint64(PCG64_MULT >> 64), np.uint64(PCG64_MULT & _U64)
    i_hi, i_lo = np.uint64(inc >> 64), np.uint64(inc & _U64)
    out = np.empty((runs, run), np.uint64)
    for t in range(run):
        if t:
            hi, lo = _muladd128(m_hi, m_lo, hi, lo, i_hi, i_lo)
        out[:, t] = _xsl_rr_np(hi, lo)
    return out.reshape(-1)[:count]


def pcg64_words(state: dict, first: int, count: int) -> np.ndarray:
    """The Generator's 32-bit words ``first .. first + count - 1`` from
    ``state``: the buffered half-word first where it holds one, then each
    64-bit output's low half, then its high half."""
    s, inc, h, u = pcg64_state(state)
    w = np.arange(first, first + count, dtype=np.int64) - h
    words = np.empty(count, np.uint32)
    buffered = w < 0
    words[buffered] = u
    if count and not buffered.all():
        j0 = int(w[~buffered][0]) >> 1
        j1 = int(w[-1]) >> 1
        outs = pcg64_outputs(s, inc, j0, j1 - j0 + 1)
        wo = w[~buffered]
        half = outs[(wo >> 1) - j0] >> (np.uint64(32) * (wo & 1).astype(np.uint64))
        words[~buffered] = (half & _LO32).astype(np.uint32)
    return words


def replay_integers(state: dict, highs, counts) -> tuple:
    """``[Generator.integers(0, highs[i], size=counts[i]) for i in order]``
    and the Generator's state after them, replayed from ``state`` (its
    ``bit_generator.state``) the card's way: the words every stratum could
    read tested for rejection under its range, the rejected draws found by
    :func:`resolve_rejections`, each draw's word its index plus the
    rejections up to it.  Returns ``(draws, state, rejections)``."""
    highs = np.asarray(highs, np.int64)
    counts = np.asarray(counts, np.int64)
    thr = lemire_thresholds(highs)
    ends = np.cumsum(counts)
    starts = ends - counts
    total = int(ends[-1]) if len(ends) else 0
    slack = rejection_slack(highs, counts)
    while True:
        cw, cs = [], []
        for st in np.flatnonzero(thr):
            w0, n_w = int(starts[st]), int(counts[st]) + slack
            u = pcg64_words(state, w0, n_w).astype(np.uint64)
            rejected = np.flatnonzero((u * np.uint64(highs[st])) & _LO32 < thr[st])
            cw.append(rejected + w0)
            cs.append(np.full(len(rejected), st, np.int64))
        rej = resolve_rejections(np.concatenate(cw or [np.zeros(0, np.int64)]),
                                 np.concatenate(cs or [np.zeros(0, np.int64)]), ends)
        if len(rej) <= slack:
            break
        slack = 2 * len(rej)
    d = np.arange(total, dtype=np.int64)
    w = d + np.searchsorted(rej, d, side="right")
    u = pcg64_words(state, 0, total + len(rej))[w].astype(np.uint64)
    n_of = np.repeat(highs, counts).astype(np.uint64)
    flat = ((u * n_of) >> np.uint64(32)).astype(np.int64)
    draws = np.split(flat, ends[:-1]) if len(ends) else []
    return draws, state_after(state, total + len(rej)), len(rej)


# the aggregates' moments: 1 the sum terms, 2 the count terms, 4 their cross term
MOMENT_SUM, MOMENT_COUNT, MOMENT_CROSS = 1, 2, 4


def resample_moments_plain(sum_terms, count_terms, n_boot: int, state: dict,
                           flags: int) -> tuple:
    """What the card's bootstrap computes: each usable stratum's ``n_boot``
    resamples of its stratum-centred terms (``sum_terms`` / ``count_terms``:
    lists of f64 arrays, or None where ``flags`` does not ask for them),
    drawn as ``Generator.integers(0, n_i, size=(n_boot, n_i))`` in stratum
    order, then per resample the mean, the ddof-1 variance over n_i and the
    cross deviations over (n_i - 1) n_i, summed over the strata in order.
    Returns ``((5, n_boot) f64: sum_shift, cnt_shift, var_sum, var_cnt,
    cov_sc (rows ``flags`` does not ask for are 0), state, rejections)``."""
    terms = sum_terms if sum_terms is not None else count_terms
    highs = np.array([len(t) for t in terms], np.int64)
    draws, new_state, n_rej = replay_integers(state, highs, n_boot * highs)
    out = np.zeros((5, n_boot))
    use_s, use_c = bool(flags & MOMENT_SUM), bool(flags & MOMENT_COUNT)
    for i, n in enumerate(highs):
        idx = draws[i].reshape(n_boot, n)
        dev = {}
        for row, use, src in ((0, use_s, sum_terms), (1, use_c, count_terms)):
            if use:
                r = src[i][idx]
                m = r.sum(axis=1) / n
                dev[row] = r - m[:, None]
                out[row] += m
                out[row + 2] += (dev[row] ** 2).sum(axis=1) / (n - 1) / n
        if flags & MOMENT_CROSS and use_s and use_c:
            out[4] += (dev[0] * dev[1]).sum(axis=1) / ((n - 1) * n)
    return out, new_state, n_rej
