"""The work of each hand-written kernel: the operations it must do on its
inputs and the bytes it must move (each input read once, each output
written once), and the peak its products are held to.  ``chip_smoke.py``
prints every kernel's bound from here, and the dry run charges a kernel's
launch on meta tensors (``roofline.trace_analysis``) with the same counts,
so the two read one definition.

    flops, byts, peak = work("flash_attention", b=..., hq=..., ...)
    bound_ms(flops, byts, peak), bound_by(flops, byts, peak)

Kernels and their shapes:

* ``sim_sweep`` (K1 at ``precision`` fp32 or bf16, K2 at int8): the fused
  pass over ``(m, d) x (n, d)``: the product, ``m // bm`` count tiles of
  ``n_bins`` int32, the top ``k`` (value, index) a row, the row's walk sums
  (f64 hi and lo, counted as 4 bytes a row as the launch writes them), the
  row scales; int8 also reads both sides' row scales;
* ``sim_topk`` (K3): the product and the top ``k`` a row, f32;
* ``sim_hist`` (K4): the product, a row scale, the ``n_bins`` histogram;
* ``flash_attention`` / ``flash_attention_bwd`` (K5): 4 operations a
  (query, key) pair and head dim that the masks leave (two products; 2 (d +
  dv) where v is ``dv`` wide, as in latent attention); the
  backward 2.5 times as many (five products: the scores again, dP, dV, dQ,
  dK); bytes q, k, v and o (and dO, dQ, dK, dV, the lse in the backward);
* ``rwkv6_scan`` / ``rwkv6_scan_bwd`` (K6): 5 f32 operations a state
  element and step (14 in the backward: the forward's S again and G, dr,
  dk, dw, dv); r, k, v at their size (``el``), w, the output and u in f32;
* ``rglru_scan`` / ``rglru_scan_bwd`` (K7): an FMA an element and step; a,
  g read and h written in f32 (the backward reads a, h, dh and writes da,
  dg: 20 bytes an element).
* ``bootstrap`` (K8): the bootstrap-t's ``draws`` resample draws over
  ``samples`` sampled pairs, ``n_boot`` resamples, the SUM or COUNT terms
  (``arrays`` 1) or both with their cross term (AVG, ``arrays`` 2): a
  draw's term added to its resample's sum and its deviation squared and
  added (an add, a subtraction and an FMA: 4 f64 operations an array),
  the cross term an FMA more; each term read once, the moments the
  aggregate reads (2 rows of n_boot f64 an array, 1 more for the cross
  term) written once, against the FP64 peak.  The integer work of the
  draws themselves is not counted.
"""
from __future__ import annotations

import numpy as np

from . import hw


def attention_pairs(sq: int, skv: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs that attention's masks leave: key j of query i
    when ``j <= i`` (causal) and ``i - j < window`` (a window), both counted
    from 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _el(dtype) -> int:
    """Bytes of an element of ``dtype`` (a torch dtype or its name)."""
    name = str(dtype).removeprefix("torch.")
    return {"float32": 4, "fp32": 4, "bfloat16": 2, "bf16": 2, "float16": 2,
            "int8": 1, "float64": 8}[name]


def _peak_of(dtype) -> float:
    return hw.PEAK_FLOPS_BF16 if _el(dtype) == 2 else hw.PEAK_FLOPS_F32


def sim_sweep(m, n, d, precision="fp32", k=32, bm=256, n_bins=4096):
    el = {"fp32": 4, "bf16": 2, "int8": 1}[precision]
    byts = (m + n) * d * el + (m + n) * 4 + (m // bm) * n_bins * 4 + m * k * 8 + m * 4
    if precision == "int8":
        byts += (m + n) * 4
    return 2.0 * m * n * d, byts, hw.PEAKS[precision]


def sim_topk(m, n, d, k=32):
    return 2.0 * m * n * d, (m + n) * d * 4 + m * k * 8, hw.PEAK_FLOPS_F32


def sim_hist(m, n, d, n_bins=4096):
    return 2.0 * m * n * d, (m + n) * d * 4 + m * 4 + n_bins * 4, hw.PEAK_FLOPS_F32


def flash_attention(b, hq, hkv, sq, skv, d, causal=True, window=0, dtype="bfloat16",
                    dv=None):
    """``dv``: v's and the output's width where it differs from q's and k's
    ``d`` (latent attention): 2 d operations a pair for q k^T, 2 dv for P v."""
    el, dv = _el(dtype), d if dv is None else dv
    flops = 2.0 * b * hq * (d + dv) * attention_pairs(sq, skv, causal, window)
    return flops, el * (b * hq * sq * (d + dv) + b * hkv * skv * (d + dv)), _peak_of(dtype)


def flash_attention_bwd(b, hq, hkv, sq, skv, d, causal=True, window=0, dtype="bfloat16"):
    el = _el(dtype)
    flops = 2.5 * 4.0 * b * hq * d * attention_pairs(sq, skv, causal, window)
    byts = el * 4 * (b * hq * sq * d + b * hkv * skv * d) + 4 * b * hq * sq
    return flops, byts, _peak_of(dtype)


def rwkv6_scan(b, h, t, hd, dtype="bfloat16"):
    n = b * h * t * hd
    return 5.0 * n * hd, 3 * n * _el(dtype) + 4 * (2 * n + h * hd), hw.PEAK_FLOPS_F32


def rwkv6_scan_bwd(b, h, t, hd, dtype="bfloat16"):
    n = b * h * t * hd
    el = _el(dtype)
    return 14.0 * n * hd, n * (3 * el + 3 * el + 3 * 4) + 8 * h * hd, hw.PEAK_FLOPS_F32


def rglru_scan(b, t, r):
    return 2.0 * b * t * r, 12 * b * t * r, hw.PEAK_FLOPS_F32


def rglru_scan_bwd(b, t, r):
    return 2.0 * b * t * r, 20 * b * t * r, hw.PEAK_FLOPS_F32


def bootstrap(draws, samples, n_boot, arrays=1):
    cross = arrays == 2
    flops = draws * (4.0 * arrays + (2.0 if cross else 0.0))
    byts = 8 * samples * arrays + 8 * n_boot * (2 * arrays + int(cross))
    return flops, byts, hw.PEAK_FLOPS_F64


KERNELS = {f.__name__: f for f in (sim_sweep, sim_topk, sim_hist, flash_attention,
                                   flash_attention_bwd, rwkv6_scan, rwkv6_scan_bwd,
                                   rglru_scan, rglru_scan_bwd, bootstrap)}


def work(kernel: str, **shape) -> tuple:
    """(operations, bytes, peak ops/s) of one launch of ``kernel`` at
    ``shape`` (the keyword arguments of its function above)."""
    return KERNELS[kernel](**shape)


def bound_ms(flops: float, byts: float, peak: float) -> float:
    """The least time the card could take for the work: the larger of the
    operations over ``peak`` and the bytes over the HBM rate, in ms."""
    return max(flops / peak, byts / hw.HBM_BW) * 1e3


def bound_by(flops: float, byts: float, peak: float) -> str:
    return "operations" if flops / peak >= byts / hw.HBM_BW else "bytes"


__all__ = ["work", "bound_ms", "bound_by", "attention_pairs", "KERNELS"]
