"""Model building blocks: norms, RoPE, GQA self- and cross-attention through
the flash attention op, SwiGLU/GeGLU MLPs, and the MoE MLP with sort-based
capacity dispatch (the reference's ``models/layers.py``).

Parameters live in :class:`torch.nn.Module` holders whose attribute names are
the reference's parameter keys (``wq``, ``w_gate``, ...), so a reference
parameter tree maps onto them by name (``repro_torch.interop``).  The
functions below take such a holder where the reference takes its dict.

Full-sequence attention goes through ``kernels.flash_attention`` (K5), where
the reference computes the same function in jnp (``chunked_attention``).
Single-token decode attention stays plain torch, as the reference computes
it outside any kernel.  Activations follow JAX's definitions: ``gelu`` is
the tanh approximation, ``rms_norm`` scales by ``1 + weight``, RoPE rotates
the two halves of a head.  Parameters are made with ``requires_grad=False``
(serving needs no gradients); the trainer (``repro_torch.train``) turns
gradients on for the parameters it updates.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt):
        ctx.dt = dt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dt), None


def grad_cast(x, dt):
    """Identity whose cotangent is cast to ``dt`` (the reference's
    ``grad_cast``): a gradient dtype barrier where an f32 island meets the
    model's stream."""
    return _GradCast.apply(x, dt)


# ----------------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    """Normal draws from ``gen`` (on its device) times ``scale``, default
    ``1/sqrt(fan_in)``, cast to ``dtype`` — the reference's scales."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def full(gen: torch.Generator, shape, value, dtype):
    return torch.full(shape, value, dtype=dtype, device=gen.device)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def rms_norm(x, weight, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x, weight, bias, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32, device=x.device)
    ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------

class Attention(nn.Module):
    """``attention_params``: wq, wk, wv, wo (+ bq, bk, bv with qkv bias)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 bias: Optional[bool] = None):
        super().__init__()
        dt = dtype_of(cfg)
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        self.wq = param(dense_init(gen, (d, nq * hd), dt))
        self.wk = param(dense_init(gen, (d, nkv * hd), dt))
        self.wv = param(dense_init(gen, (d, nkv * hd), dt))
        self.wo = param(dense_init(gen, (nq * hd, d), dt))
        if cfg.qkv_bias if bias is None else bias:
            self.bq = param(full(gen, (nq * hd,), 0.0, dt))
            self.bk = param(full(gen, (nkv * hd,), 0.0, dt))
            self.bv = param(full(gen, (nkv * hd,), 0.0, dt))


def _qkv(p: Attention, cfg: ModelConfig, x, kv_x=None):
    """Project to (B, S, n, hd) heads; keys and values from ``kv_x`` (B,
    Skv, d) when given (cross-attention), else from ``x``."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    skv = kv_x.shape[1]
    q, k, v = x @ p.wq, kv_x @ p.wk, kv_x @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, skv, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, skv, cfg.num_kv_heads, cfg.head_dim))


def _grouped_scores(q, k):
    """q: (B, S, nq, hd), k: (B, T, nkv, hd) -> f32 scores (B, nkv, G, S, T)
    without materialising repeated KV heads."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    return torch.einsum("bsngh,btnh->bngst", qg.float(), k.float())


def _grouped_out(probs, v):
    """probs: (B, nkv, G, S, T), v: (B, T, nkv, hd) -> (B, S, nq, hd)."""
    b, nkv, g, s, _ = probs.shape
    out = torch.einsum("bngst,btnh->bsngh", probs.to(v.dtype), v)
    return out.reshape(b, s, nkv * g, v.shape[-1])


def chunked_attention(p: Attention, cfg: ModelConfig, x, positions,
                      kv_x=None, kv_positions=None, causal: bool = True,
                      window: int = 0, use_rope: bool = True):
    """Full-sequence attention through the flash-attention op (K5 on the
    card, its plain version on the CPU), in the kernel's layout: (B, Hq, S,
    d) queries against (B, Hkv, Skv, d) keys and values, which come from
    ``kv_x`` (cross-attention) or from ``x``.  The kernel masks by position
    counted from 0 in both q and k, which is what ``positions`` and
    ``kv_positions`` are on every forward path (an ``arange``); they feed
    RoPE, which ``use_rope=False`` leaves out.  The kernel computes P.V with
    f32 P (at bf16 on the tensor cores, each P as three exact bf16 terms)
    where the reference casts the probabilities to the model type first, so
    at bf16 the two differ by bf16 rounding."""
    b, s, _ = x.shape
    q, k, v = (t.transpose(1, 2) for t in _qkv(p, cfg, x, kv_x))
    kv_positions = positions if kv_positions is None else kv_positions
    if use_rope:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, kv_positions[:, None, :], cfg.rope_theta)
    if cfg.bf16_backward:
        # the reference's dtype barrier at the attention's f32 island
        q, k, v = (grad_cast(t, x.dtype) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window)
    return out.transpose(1, 2).reshape(b, s, -1) @ p.wo


def decode_attention(p: Attention, cfg: ModelConfig, x, cache_k, cache_v,
                     position, window: int = 0, use_rope: bool = True):
    """Single-token decode: write this step's K/V into the cache and attend
    over it (plain torch, no kernel).

    x: (B, 1, d); cache_k/v: (B, T_max, nkv, hd); position: a scalar (every
    row at the same step) or (B,) per-slot positions in [0, T_max), so a
    freshly admitted request never attends to a previous occupant's stale
    entries.  The cache is updated in place (the reference returns a new
    one); returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    position = torch.as_tensor(position, dtype=torch.int64, device=x.device)
    per_slot = position.ndim == 1
    pos_b = position if per_slot else position.expand(b)
    pos = pos_b[:, None]
    if use_rope:
        q = apply_rope(q.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, pos_b] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos_b] = v[:, 0].to(cache_v.dtype)
    kv_pos = torch.arange(cache_k.shape[1], device=x.device)[None, :]
    scores = _grouped_scores(q, cache_k) * cfg.head_dim**-0.5  # (B, nkv, G, 1, T)
    mask = kv_pos[:, None, None, None, :] <= pos_b[:, None, None, None, None]
    if window > 0:
        mask = mask & (kv_pos[:, None, None, None, :] > pos_b[:, None, None, None, None] - window)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = _grouped_out(probs, cache_v).reshape(b, 1, -1) @ p.wo
    return out, cache_k, cache_v


def ring_decode_attention(p: Attention, cfg: ModelConfig, x, k_cache, v_cache,
                          position, w: int):
    """Sliding-window decode over a ring-buffer cache of ``w`` slots (the
    hybrid's local attention): this step's K/V go to slot ``position % w``,
    and a slot is read while the absolute position it holds lies in
    ``(position - w, position]``.  x: (B, 1, d); k/v_cache: (B, w, nkv,
    hd), updated in place; position: one scalar for the batch (the ring
    cannot be rewound per slot).  Returns out (B, 1, d)."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    position = torch.as_tensor(position, dtype=torch.int64, device=x.device)
    if position.ndim:
        raise ValueError("a ring-buffer cache takes one position for the whole batch")
    pos = position.expand(b)[:, None]
    q = apply_rope(q.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
    slot = position % w
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    idx = torch.arange(w, device=x.device)
    slot_pos = position - ((position - idx) % w)  # absolute position a slot holds
    valid = (slot_pos <= position) & (slot_pos > position - w) & (slot_pos >= 0)
    scores = _grouped_scores(q, k_cache) * cfg.head_dim**-0.5
    scores = torch.where(valid, scores, torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v_cache).reshape(b, 1, -1) @ p.wo


def cross_decode_attention(p: Attention, cfg: ModelConfig, x, xk, xv, n_valid: int):
    """One decoder token's cross-attention over precomputed encoder K/V
    (B, T, nkv, hd), of which the first ``n_valid`` frames are real and the
    rest cache padding (masked).  x: (B, 1, d).  Returns out (B, 1, d)."""
    b = x.shape[0]
    q = (x @ p.wq).reshape(b, 1, cfg.num_heads, cfg.head_dim)
    scores = _grouped_scores(q, xk) * cfg.head_dim**-0.5
    valid = torch.arange(xk.shape[1], device=x.device) < n_valid
    scores = torch.where(valid, scores, torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, xv).reshape(b, 1, -1) @ p.wo


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    """``mlp_params``: gated (w_gate, w_up, w_down) for silu / geglu, else the
    plain 2-matrix MLP with biases."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        dt = dtype_of(cfg)
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        if cfg.act in ("silu", "geglu"):
            self.w_gate = param(dense_init(gen, (d, ff), dt))
            self.w_up = param(dense_init(gen, (d, ff), dt))
            self.w_down = param(dense_init(gen, (ff, d), dt))
        else:
            self.w_up = param(dense_init(gen, (d, ff), dt))
            self.b_up = param(full(gen, (ff,), 0.0, dt))
            self.w_down = param(dense_init(gen, (ff, d), dt))
            self.b_down = param(full(gen, (d,), 0.0, dt))


gelu = functools.partial(F.gelu, approximate="tanh")  # jax.nn.gelu's default


def mlp(p: MLP, cfg: ModelConfig, x):
    if hasattr(p, "w_gate"):
        act = F.silu if cfg.act == "silu" else gelu
        return (act(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    return gelu(x @ p.w_up + p.b_up) @ p.w_down + p.b_down


# ----------------------------------------------------------------------------
# MoE: top-k routing + sort-based capacity dispatch (one group on one card)
# ----------------------------------------------------------------------------

class MoE(nn.Module):
    """``moe_params``: an f32 router and stacked expert matrices."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg)
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = param(dense_init(gen, (d, e), torch.float32))
        self.w_gate = param(dense_init(gen, (e, d, ff), dt))
        self.w_up = param(dense_init(gen, (e, d, ff), dt))
        self.w_down = param(dense_init(gen, (e, ff, d), dt))


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: every token of the batch,
    padding rows included, so a row's routing depends on its batch-mates."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return max(int(np.ceil(tokens * k / e * cfg.moe_capacity_factor)), 1)


def moe_route(p: MoE, cfg: ModelConfig, xt):
    """Routing of (T, d) tokens: the f32 router's softmax, its top k with
    the weights normalised, and which (token, choice) pairs keep a slot.
    Returns (top_e (T, k), top_w (T, k) f32, keep (T, k) bool, slot (T, k):
    the row of the (E * cap) capacity buffer a kept pair takes).

    Pairs are grouped by expert in the order of a stable argsort of the
    flattened (T * k) choices, as ``jnp.argsort`` orders them; an expert's
    pairs past its capacity are dropped in that order."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = moe_capacity(cfg, t)
    flat_e = top_e.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    start = torch.searchsorted(e_sorted, torch.arange(e, device=xt.device))
    pos_in_e = torch.arange(t * k, device=xt.device) - start[e_sorted]
    # back to (token, choice) order
    pos = torch.empty_like(pos_in_e)
    pos[order] = pos_in_e
    keep = (pos < cap).reshape(t, k)
    slot = (flat_e * cap + pos).reshape(t, k)
    return top_e, top_w, keep, slot


def moe_mlp(p: MoE, cfg: ModelConfig, x):
    """x: (B, S, d).  Tokens go to their top-k experts through an (E, cap,
    d) capacity buffer; overflow is dropped (Switch behaviour).  The expert
    products are batched matmuls.  A token's k contributions are put back
    in (token, choice) order and summed over k, so the same batch gives the
    same bits on every run (no atomic scatter-add)."""
    b, s, d = x.shape
    e = cfg.num_experts
    xt = x.reshape(b * s, d)
    top_e, top_w, keep, slot = moe_route(p, cfg, xt)
    cap = moe_capacity(cfg, b * s)
    k = top_e.shape[1]
    tok = torch.arange(b * s, device=x.device)[:, None].expand(-1, k)
    buf = x.new_zeros((e * cap, d))
    buf[slot[keep]] = xt[tok[keep]]
    buf = buf.reshape(e, cap, d)
    act = F.silu if cfg.act in ("silu", "geglu") else gelu
    h = act(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_buf = torch.bmm(h, p.w_down).reshape(e * cap, d)
    picked = out_buf[slot.clamp_max(e * cap - 1)]           # (T, k, d)
    contrib = torch.where(keep[..., None], picked, picked.new_zeros(()))
    contrib = contrib * top_w[..., None].to(x.dtype)
    return contrib.sum(dim=1).reshape(b, s, d)
