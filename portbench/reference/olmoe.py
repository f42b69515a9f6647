"""Plain forward of the served mixture-of-experts decoder in f32, to the last
position's YES / NO logits, for whole scorer batches.

The layer equations, written from the model's description (OLMoE,
arXiv:2409.02060) as the system serves it:

    x   = embed[tokens]
    x  += Attn(RMS(x; ln1))      causal softmax(q k^T / sqrt(hd)) v, RoPE on
                                  q and k (halves rotated, theta 10,000)
    x  += MoE(RMS(x; ln2))       softmax router, top k experts, their weights
                                  renormalised to sum 1; SwiGLU experts
    P   = softmax over [YES, NO] of RMS(x_last; ln_f) @ head

RMS(x; w) = x / sqrt(mean(x^2) + eps) * (1 + w).  The MoE gives each
expert ``ceil(T k / E * capacity_factor)`` slots for the T tokens of a
batch, padding included, and drops an expert's (token, choice) pairs past
its slots in token-major order; a dropped pair adds nothing.  Departures
from the published model, which the system makes and so this does: no QK
norm, the top-k weights renormalised, and dropping at capacity.

Weights are the benchmark's own tensors (``layers.<l>.<...>`` names), read
one layer at a time and widened to f32.  ``fp8=True`` is the control: each
product's weight (per output column) and input (per row) rounded to
float8 e4m3, one precision below the served bf16.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, -2)
    return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    """x: (B, H, S, hd)."""
    hd, s = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    ang = (torch.arange(s, dtype=torch.float64)[:, None] * freqs).to(torch.float32)
    cos, sin = ang.cos().to(x.device), ang.sin().to(x.device)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(h, w, m, fp8):
    b, s, _ = h.shape
    nq, nkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = _mm(h, w["attn.wq"], fp8).view(b, s, nq, hd).transpose(1, 2)
    k = _mm(h, w["attn.wk"], fp8).view(b, s, nkv, hd).transpose(1, 2)
    v = _mm(h, w["attn.wv"], fp8).view(b, s, nkv, hd).transpose(1, 2)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    if nkv != nq:
        k = k.repeat_interleave(nq // nkv, dim=1)
        v = v.repeat_interleave(nq // nkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = (p @ v).transpose(1, 2).reshape(b, s, nq * hd)
    return _mm(o, w["attn.wo"], fp8)


def _moe(h, w, m, fp8):
    b, s, d = h.shape
    t = b * s
    e, k = m["num_experts"], m["num_experts_per_tok"]
    x = h.reshape(t, d)
    probs = torch.softmax(x @ w["moe.router"], dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    cap = max(math.ceil(t * k / e * m["moe_capacity_factor"]), 1)
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    start = torch.searchsorted(flat[order], torch.arange(e, device=x.device))
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(t * k, device=x.device) - start[flat[order]]
    keep = (pos < cap).view(t, k)
    out = torch.zeros(t, k, d, device=x.device)
    for ex in range(e):
        tok, choice = torch.nonzero((top_e == ex) & keep, as_tuple=True)
        if len(tok) == 0:
            continue
        xe = x[tok]
        y = F.silu(_mm(xe, w["moe.w_gate"][ex], fp8)) * _mm(xe, w["moe.w_up"][ex], fp8)
        out[tok, choice] = _mm(y, w["moe.w_down"][ex], fp8) * top_w[tok, choice, None]
    return out.sum(1).view(b, s, d)


def _layer_weights(weights: dict, layer: int) -> dict:
    pre = f"layers.{layer}."
    return {n[len(pre):]: t.float() for n, t in weights.items() if n.startswith(pre)}


@torch.no_grad()
def yes_probs(weights: dict, model: dict, batches: list, yes: int, no: int,
              fp8: bool = False, device="cuda") -> list:
    """P(YES) against NO at each row's last position, f64 numpy, one array a
    batch; ``batches`` are (tokens (B, S), last (B,)) pairs, run together
    layer by layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    eps = model["norm_eps"]
    xs = [weights["embed"][torch.as_tensor(t, device=dev)].float() for t, _ in batches]
    for layer in range(model["num_layers"]):
        w = _layer_weights(weights, layer)
        for i, x in enumerate(xs):
            x = x + _attention(_rms(x, w["ln1"], eps), w, model, fp8)
            xs[i] = x + _moe(_rms(x, w["ln2"], eps), w, model, fp8)
        del w
    head = weights["head"][:, [yes, no]].float()
    ln_f = weights["ln_f"].float()
    out = []
    for x, (_, last) in zip(xs, batches):
        rows = torch.arange(x.shape[0], device=dev)
        h = _rms(x[rows, torch.as_tensor(last, device=dev)], ln_f, eps)
        lg = _mm(h, head, fp8).double().cpu().numpy()
        z = lg - lg.max(axis=1, keepdims=True)
        e = np.exp(z)
        out.append(e[:, 0] / e.sum(axis=1))
    return out
