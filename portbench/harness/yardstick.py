"""Frozen yardsticks: the card's published peaks, the work of the sweep
kernel and the useful operations of the Oracle model.

These are copies, not imports: a change to the program must not move the
numbers it is judged by.  The peaks and the sweep's bytes are those of the
port's ``roofline/hw.py`` and ``roofline/kernel_work.sim_sweep``; the
model's operations follow from the configuration alone.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 datasheet, dense: FP32 on the CUDA cores, BF16 on the
# tensor cores (1,979 / 2 without sparsity), HBM3 bandwidth
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
PEAKS = {"fp32": PEAK_FLOPS_F32, "bf16": PEAK_FLOPS_BF16}


def sim_sweep(m: int, n: int, d: int, precision: str = "fp32", k: int = 32,
              bm: int = 256, n_bins: int = 4096) -> tuple:
    """(operations, bytes, peak) of one fused sweep over (m, d) x (n, d):
    the product; each side's rows read once; a row scale and a column
    vector; ``m // bm`` count tiles of ``n_bins`` int32; the top ``k``
    (value, index) of each row; each row's walk sum, counted as 4 bytes."""
    el = {"fp32": 4, "bf16": 2}[precision]
    byts = ((m + n) * d * el + (m + n) * 4 + (m // bm) * n_bins * 4
            + m * k * 8 + m * 4)
    return 2.0 * m * n * d, byts, PEAKS[precision]


def bound_s(ops: float, byts: float, peak: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak and the bytes over the HBM rate."""
    return max(ops / peak, byts / HBM_BW)


def token_flops(model: dict) -> float:
    """Operations of the products one token passes through in the decoder
    stack, 2 a multiply-add: the attention projections, the router and the
    experts it is sent to (or the dense MLP)."""
    d, hd = model["d_model"], model["head_dim"]
    nq, nkv = model["num_heads"], model["num_kv_heads"]
    ff = model["d_ff"]
    attn = d * hd * (nq + 2 * nkv) + nq * hd * d
    e, k = model.get("num_experts", 0), model.get("num_experts_per_tok", 0)
    mlp = d * e + k * 3 * d * ff if e else 3 * d * ff
    return 2.0 * model["num_layers"] * (attn + mlp)


def attention_flops(model: dict, length: int) -> float:
    """QK^T and P.V of one causal sequence of ``length`` tokens: position t
    sees t + 1 keys, 4 operations a key and head dim."""
    pairs = length * (length + 1) // 2
    return 4.0 * model["num_layers"] * model["num_heads"] * model["head_dim"] * pairs


def head_flops(model: dict) -> float:
    """The LM head at the one position the scorer reads."""
    return 2.0 * model["d_model"] * model["vocab_size"]


def pair_flops(model: dict, length: int) -> float:
    """Useful operations of scoring one pair whose prompt has ``length``
    tokens: no padded position, padding row or capacity slot counts."""
    return length * token_flops(model) + attention_flops(model, length) + head_flops(model)
