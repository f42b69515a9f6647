"""Model building blocks: norms, RoPE, GQA self- and cross-attention through
the flash attention op, SwiGLU/GeGLU MLPs, and the MoE MLP with sort-based
capacity dispatch (the reference's ``models/layers.py``); beyond the
reference, DeepSeek-V3's latent attention (:class:`MLA`), its sigmoid
router with a selection bias, shared experts, and a dropless dispatch.

Parameters live in :class:`torch.nn.Module` holders whose attribute names are
the reference's parameter keys (``wq``, ``w_gate``, ...), so a reference
parameter tree maps onto them by name (``repro_torch.interop``).  The
functions below take such a holder where the reference takes its dict.

Full-sequence attention goes through ``kernels.flash_attention`` (K5), where
the reference computes the same function in jnp (``chunked_attention``).
Single-token decode attention stays plain torch, as the reference computes
it outside any kernel; on a sharded model whose cache splits its slots over
"model" it is sequence-parallel (``train.sharded.split_softmax``).

On a sharded model (``models.partition.shard_params``) each block reads
its parameters through ``train.sharded``'s prologue, which gathers their
FSDP shards and says whether the block splits its heads, channels or
experts over the "model" axis (a :class:`~repro_torch.train.sharded.Tp`)
or computes them replicated; the same code runs unsharded, where every
``Tp`` method is the identity.  Head counts come from the local
projections' widths.  Activations follow JAX's definitions: ``gelu`` is
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
from ..obs import telemetry
from .config import ModelConfig


def sharded_ops():
    """``repro_torch.train.sharded``, imported at first use (the training
    package imports the models)."""
    from ..train import sharded

    return sharded


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
    ``1/sqrt(fan_in)``, cast to ``dtype`` — the reference's scales.  On the
    meta device (:class:`MetaGenerator`) an empty tensor of the shape."""
    if gen.device.type == "meta":  # the dry run's shapes: nothing is drawn
        return torch.empty(shape, dtype=dtype, device=gen.device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


class MetaGenerator:
    """What ``init_params`` hands the layers on the meta device, where
    ``torch.Generator`` cannot be made: a device and no draws."""
    device = torch.device("meta")


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


def apply_rope_interleaved(x, positions, theta: float):
    """RoPE over pairs of adjacent dims (2i, 2i + 1), as DeepSeek-V3's
    published code pairs them: the pairs' first and second members are
    gathered into two halves, which :func:`apply_rope` rotates (the
    output stays in that order; q and k share it, so q . k is the
    interleaved rotation's)."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return apply_rope(x, positions, theta)


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


def _qkv(p: Attention, cfg: ModelConfig, x, kv_x=None, tp=None, kv_head=None):
    """Project to (B, S, n, hd) heads; keys and values from ``kv_x`` (B,
    Skv, d) when given (cross-attention), else from ``x``.  With ``tp`` the
    projections are the rank's heads: the inputs enter the split block
    (``tp.enter``), except where ``kv_head`` names the one kv head this
    rank's query heads read, which it takes from K and V computed whole."""
    b, s, _ = x.shape
    tp = tp or sharded_ops().NO_TP
    src = x if kv_x is None else kv_x
    skv = src.shape[1]
    xin = tp.enter(x)
    kin = src if kv_head is not None else xin if kv_x is None else tp.enter(kv_x)
    q, k, v = xin @ p.wq, kin @ p.wk, kin @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    hd = cfg.head_dim
    q, k, v = q.reshape(b, s, -1, hd), k.reshape(b, skv, -1, hd), v.reshape(b, skv, -1, hd)
    if kv_head is not None:
        k, v = (tp.enter(t)[:, :, kv_head:kv_head + 1] for t in (k, v))
    return q, k, v


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
    p, tp, kv_head = sharded_ops().attention(p, cfg)
    q, k, v = (t.transpose(1, 2) for t in _qkv(p, cfg, x, kv_x, tp, kv_head))
    kv_positions = positions if kv_positions is None else kv_positions
    if use_rope:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, kv_positions[:, None, :], cfg.rope_theta)
    if cfg.bf16_backward:
        # the reference's dtype barrier at the attention's f32 island
        q, k, v = (grad_cast(t, x.dtype) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window)
    return tp.reduce(out.transpose(1, 2).reshape(b, s, -1) @ p.wo)


class MLA(nn.Module):
    """Latent attention (DeepSeek-V2/V3) without a q LoRA: ``wq``; ``wkv_a``
    to the KV latent and the one RoPE key all heads share, ``kv_norm``,
    ``wkv_b`` to each head's k_nope and v; ``wo`` from the heads' v width."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg)
        d, nq = cfg.d_model, cfg.num_heads
        self.wq = param(dense_init(gen, (d, nq * cfg.qk_head_dim), dt))
        self.wkv_a = param(dense_init(gen, (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dt))
        self.kv_norm = param(full(gen, (cfg.kv_lora_rank,), 0.0, torch.float32))
        self.wkv_b = param(dense_init(
            gen, (cfg.kv_lora_rank, nq * (cfg.qk_nope_head_dim + cfg.v_head_dim)), dt))
        self.wo = param(dense_init(gen, (nq * cfg.v_head_dim, d), dt))


def attention_params(cfg: ModelConfig, gen: torch.Generator):
    """A decoder layer's self-attention holder: :class:`MLA` where the
    config has a KV latent, else :class:`Attention`."""
    return MLA(cfg, gen) if cfg.is_mla else Attention(cfg, gen)


def mla_attention(p: MLA, cfg: ModelConfig, x, positions, causal: bool = True,
                  window: int = 0):
    """Full-sequence latent attention, the latent expanded to every head's
    k and v (no latent cache: the port only prefills MLA):

        q = x W_q                           -> (B, H, S, nope + rope)
        [c | k_pe] = x W_kv_a,  c = RMS(c; kv_norm)
        [k_nope | v] = c W_kv_b             -> (B, H, S, nope + v)
        q_pe, k_pe rotated (interleaved pairs), k_pe shared by every head
        out = softmax([q_nope | q_pe] [k_nope | k_pe]^T (nope + rope)^-0.5) v W_o

    through K5 at its two widths (q and k nope + rope, v and the output
    v_head_dim), none padded."""
    if sharded_ops().sharded(p):
        raise NotImplementedError("latent attention has no sharding rules")
    b, s, _ = x.shape
    nq, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_pe = (x @ p.wq).reshape(b, s, nq, nope + rope).transpose(1, 2).split([nope, rope], -1)
    c_kv, k_pe = (x @ p.wkv_a).split([cfg.kv_lora_rank, rope], -1)
    kv = rms_norm(c_kv, p.kv_norm, cfg.norm_eps) @ p.wkv_b
    k_nope, v = kv.reshape(b, s, nq, nope + cfg.v_head_dim).transpose(1, 2).split(
        [nope, cfg.v_head_dim], -1)
    pos = positions[:, None, :]
    q_pe = apply_rope_interleaved(q_pe, pos, cfg.rope_theta)
    k_pe = apply_rope_interleaved(k_pe[:, None], pos, cfg.rope_theta)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(b, nq, s, rope)], -1)
    out = flash_attention(q, k, v, causal=causal, window=window)
    return out.transpose(1, 2).reshape(b, s, -1) @ p.wo


def self_attention(p, cfg: ModelConfig, x, positions, causal: bool = True, window: int = 0):
    """A decoder layer's full-sequence self-attention, by its holder's kind."""
    if isinstance(p, MLA):
        return mla_attention(p, cfg, x, positions, causal=causal, window=window)
    return chunked_attention(p, cfg, x, positions, causal=causal, window=window)


def _decode_qkv(p, cfg: ModelConfig, x, tp, kv_head, all_heads: bool):
    """This step's (B, 1, n, hd) q, k, v under attention's plan (``tp``,
    ``kv_head``: ``train.sharded.attention``).  Where the cache holds every
    kv head (``all_heads``), every head: heads the plan splits are gathered
    over "model", and a plan that reads one kv head a rank takes K and V
    whole (its ``wk`` / ``wv`` are gathered whole).  Else the rank's heads,
    which must be the kv heads its cache block holds."""
    q, k, v = _qkv(p, cfg, x, tp=tp)
    if tp.n > 1 and all_heads:
        q = tp.gather(q, 2)
        if kv_head is None:
            k, v = tp.gather(k, 2), tp.gather(v, 2)
    elif not all_heads and (tp.n == 1 or kv_head is not None):
        raise ValueError("the cache splits its kv heads over 'model' where the attention "
                         "does not")
    return q, k, v


def _attend(q, cache_k, cache_v, mask, slots, head_dim: int):
    """q (B, 1, H, hd) over the cache's slots where ``mask`` holds (the
    reference's -1e30 elsewhere) -> (B, 1, H, hd); with the slots split
    over ``slots``' ranks, the softmax combined over them
    (``train.sharded.split_softmax``)."""
    scores = _grouped_scores(q, cache_k) * head_dim**-0.5  # (B, nkv, G, 1, T)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    if slots.n > 1:
        return sharded_ops().split_softmax(scores, cache_v, slots)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, cache_v)


def _decode_out(p, tp, out, all_heads: bool):
    """(B, 1, H, hd) through ``wo``: with the heads split over "model", the
    rank's heads into its rows of the row-parallel ``wo``, summed over the
    model ranks."""
    b = out.shape[0]
    if tp.n > 1 and all_heads:
        per = out.shape[2] // tp.n
        out = out.narrow(2, tp.index * per, per)
    return tp.reduce(out.reshape(b, 1, -1) @ p.wo)


def decode_attention(p: Attention, cfg: ModelConfig, x, cache_k, cache_v,
                     position, window: int = 0, use_rope: bool = True, slots=None):
    """Single-token decode: write this step's K/V into the cache and attend
    over it (plain torch, no kernel).

    x: (B, 1, d); cache_k/v: (B, T_max, nkv, hd); position: a scalar (every
    row at the same step) or (B,) per-slot positions in [0, T_max), so a
    freshly admitted request never attends to a previous occupant's stale
    entries.  The cache is updated in place (the reference returns a new
    one); returns (out, cache_k, cache_v).

    On a sharded model ``slots`` (a ``train.sharded.Tp``) is the model axis
    where the cache holds this rank's block of T_max / n slots: the owner
    of a row's slot writes it, and the softmax runs over every rank's
    slots (``train.sharded.split_softmax``)."""
    b = x.shape[0]
    sh = sharded_ops()
    slots = slots or sh.NO_TP
    p, tp, kv_head = sh.attention(p, cfg)
    all_heads = cache_k.shape[2] == cfg.num_kv_heads
    q, k, v = _decode_qkv(p, cfg, x, tp, kv_head, all_heads)
    position = torch.as_tensor(position, dtype=torch.int64, device=x.device)
    per_slot = position.ndim == 1
    pos_b = position if per_slot else position.expand(b)
    pos = pos_b[:, None]
    if use_rope:
        q = apply_rope(q.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
    if slots.n > 1:
        sh.write_slot(cache_k, pos_b, k[:, 0], slots)
        sh.write_slot(cache_v, pos_b, v[:, 0], slots)
    else:
        rows = torch.arange(b, device=x.device)
        cache_k[rows, pos_b] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos_b] = v[:, 0].to(cache_v.dtype)
    tl = cache_k.shape[1]
    kv_pos = torch.arange(slots.index * tl, (slots.index + 1) * tl, device=x.device)[None, :]
    mask = kv_pos[:, None, None, None, :] <= pos_b[:, None, None, None, None]
    if window > 0:
        mask = mask & (kv_pos[:, None, None, None, :] > pos_b[:, None, None, None, None] - window)
    out = _attend(q, cache_k, cache_v, mask, slots, cfg.head_dim)
    return _decode_out(p, tp, out, all_heads), cache_k, cache_v


def ring_decode_attention(p: Attention, cfg: ModelConfig, x, k_cache, v_cache,
                          position, w: int, slots=None):
    """Sliding-window decode over a ring-buffer cache of ``w`` slots (the
    hybrid's local attention): this step's K/V go to slot ``position % w``,
    and a slot is read while the absolute position it holds lies in
    ``(position - w, position]``.  x: (B, 1, d); k/v_cache: (B, w, nkv,
    hd), updated in place; position: one scalar for the batch (the ring
    cannot be rewound per slot).  With ``slots`` split (a sharded model's
    ring, as :func:`decode_attention`), the rank holds ring slots ``index *
    w / n`` onward and a slot's validity comes from its global index.
    Returns out (B, 1, d)."""
    b = x.shape[0]
    sh = sharded_ops()
    slots = slots or sh.NO_TP
    p, tp, kv_head = sh.attention(p, cfg)
    all_heads = k_cache.shape[2] == cfg.num_kv_heads
    q, k, v = _decode_qkv(p, cfg, x, tp, kv_head, all_heads)
    position = torch.as_tensor(position, dtype=torch.int64, device=x.device)
    if position.ndim:
        raise ValueError("a ring-buffer cache takes one position for the whole batch")
    pos = position.expand(b)[:, None]
    q = apply_rope(q.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k.transpose(1, 2), pos[:, None, :], cfg.rope_theta).transpose(1, 2)
    if slots.n > 1:
        slot = (position % w).expand(b)
        sh.write_slot(k_cache, slot, k[:, 0], slots)
        sh.write_slot(v_cache, slot, v[:, 0], slots)
    else:
        slot = (position % w).reshape(1)  # an index tensor: no read of its value
        k_cache[:, slot] = k.to(k_cache.dtype)
        v_cache[:, slot] = v.to(v_cache.dtype)
    wl = k_cache.shape[1]
    idx = torch.arange(slots.index * wl, (slots.index + 1) * wl, device=x.device)
    slot_pos = position - ((position - idx) % w)  # absolute position a slot holds
    valid = (slot_pos <= position) & (slot_pos > position - w) & (slot_pos >= 0)
    out = _attend(q, k_cache, v_cache, valid, slots, cfg.head_dim)
    return _decode_out(p, tp, out, all_heads)


def cross_decode_attention(p: Attention, cfg: ModelConfig, x, xk, xv, n_valid: int,
                           frames=None):
    """One decoder token's cross-attention over precomputed encoder K/V
    (B, T, nkv, hd), of which the first ``n_valid`` frames are real and the
    rest cache padding (masked).  x: (B, 1, d).  With ``frames`` split (a
    sharded model's cache, as :func:`decode_attention`'s slots) the rank
    holds frames ``index * T / n`` onward, masked by their global index.
    Returns out (B, 1, d)."""
    b = x.shape[0]
    sh = sharded_ops()
    frames = frames or sh.NO_TP
    p, tp, _ = sh.attention(p, cfg)
    all_heads = xk.shape[2] == cfg.num_kv_heads
    q = (tp.enter(x) @ p.wq).reshape(b, 1, -1, cfg.head_dim)
    if tp.n > 1 and all_heads:
        q = tp.gather(q, 2)
    tl = xk.shape[1]
    valid = torch.arange(frames.index * tl, (frames.index + 1) * tl, device=x.device) < n_valid
    out = _attend(q, xk, xv, valid, frames, cfg.head_dim)
    return _decode_out(p, tp, out, all_heads)


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
    """Column-parallel ``w_gate`` / ``w_up`` and row-parallel ``w_down``
    when the block splits its ``mlp`` dim over "model"."""
    p, tp = sharded_ops().mlp(p)
    x = tp.enter(x)
    if hasattr(p, "w_gate"):
        act = F.silu if cfg.act == "silu" else gelu
        return tp.reduce((act(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down)
    return tp.reduce(gelu(x @ p.w_up + p.b_up) @ p.w_down) + p.b_down


# ----------------------------------------------------------------------------
# MoE: top-k routing + sort-based capacity dispatch, one group per batch
# shard; or dropless (``moe_capacity_factor`` 0), every routed pair run
# ----------------------------------------------------------------------------

class MoE(nn.Module):
    """``moe_params``: an f32 router and stacked expert matrices of width
    ``cfg.expert_d_ff``; with ``cfg.router_bias`` the f32 selection bias
    ``router_bias`` (DeepSeek-V3's ``e_score_correction_bias``), with
    ``cfg.shared_experts`` the MLP ``shared`` of their summed width."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg)
        d, ff, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
        self.router = param(dense_init(gen, (d, e), torch.float32))
        self.w_gate = param(dense_init(gen, (e, d, ff), dt))
        self.w_up = param(dense_init(gen, (e, d, ff), dt))
        self.w_down = param(dense_init(gen, (e, ff, d), dt))
        if cfg.router_bias:
            self.router_bias = param(full(gen, (e,), 0.0, torch.float32))
        if cfg.shared_experts:
            self.shared = MLP(cfg, gen, d_ff=cfg.shared_experts * ff)


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: every token of the batch,
    padding rows included, so a row's routing depends on its batch-mates."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return max(int(np.ceil(tokens * k / e * cfg.moe_capacity_factor)), 1)


def moe_select(p: MoE, cfg: ModelConfig, xt):
    """Each of (T, d) tokens' experts and their weights, from the f32
    router's scores: its softmax (``cfg.router``), or its sigmoid, whose
    top k are chosen by score plus ``router_bias`` where the holder has one
    while the weights are the scores alone (DeepSeek-V3's noaux_tc with one
    group); the weights renormalised to sum 1 (``cfg.norm_topk_prob``, the
    sum held at 1e-9 or more) and times ``cfg.routed_scaling_factor``.
    Returns (top_e (T, k), top_w (T, k) f32), the choices by descending
    selection score."""
    k = cfg.num_experts_per_tok
    logits = xt.float() @ p.router
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    bias = getattr(p, "router_bias", None)
    if bias is None:
        top_w, top_e = torch.topk(scores, k, dim=-1)
    else:
        top_e = torch.topk(scores + bias, k, dim=-1).indices
        top_w = scores.gather(-1, top_e)
    if cfg.norm_topk_prob:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    if cfg.routed_scaling_factor != 1.0:
        top_w = top_w * cfg.routed_scaling_factor
    return top_e, top_w


def moe_route(p: MoE, cfg: ModelConfig, xt):
    """Routing of (T, d) tokens (:func:`moe_select`) and which (token,
    choice) pairs keep a slot.  Returns (top_e (T, k), top_w (T, k) f32,
    keep (T, k) bool, slot (T, k): the row of the (E * cap) capacity buffer
    a kept pair takes).

    Pairs are grouped by expert in the order of a stable argsort of the
    flattened (T * k) choices, as ``jnp.argsort`` orders them; an expert's
    pairs past its capacity are dropped in that order."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    top_e, top_w = moe_select(p, cfg, xt)
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
    """x: (B, S, d).  The routed experts, by the capacity dispatch
    (:func:`moe_capacity_mlp`) or, with ``cfg.moe_capacity_factor`` 0, the
    dropless one (:func:`moe_dropless_mlp`), plus the shared expert where
    the holder has one."""
    out = moe_dropless_mlp(p, cfg, x) if cfg.dropless else moe_capacity_mlp(p, cfg, x)
    if hasattr(p, "shared"):
        out = out + mlp(p.shared, cfg, x)
    return out


def expert_matmul(x, w, counts, offs, grouped: Optional[bool] = None):
    """(N, d_in) rows grouped by expert, ``counts`` (E,) rows an expert and
    their running sums ``offs`` (int32), through each one's (d_in, d_out)
    matrix of ``w`` (E, d_in, d_out).  ``grouped`` (default: on a card) is
    one ``torch._grouped_mm`` over the device offsets, with no copy to the
    host; else one product an expert, over the counts read on the host."""
    if x.is_cuda if grouped is None else grouped:
        return torch._grouped_mm(x, w, offs=offs)
    out = x.new_empty((x.shape[0], w.shape[2]))
    at = 0
    for ex, n in enumerate(counts.tolist()):
        if n:
            out[at:at + n] = x[at:at + n] @ w[ex]
            at += n
    return out


def moe_dropless_mlp(p: MoE, cfg: ModelConfig, x, grouped: Optional[bool] = None):
    """x: (B, S, d).  Every (token, choice) pair runs its expert: the pairs
    sorted by expert by a stable argsort of the flattened (T * k) choices
    (token-major within an expert, as :func:`moe_route` orders them), each
    expert's SwiGLU over exactly its own rows (:func:`expert_matmul`), the
    results put back in (token, choice) order and summed over k, so the same
    batch gives the same bits on every run (no atomic scatter-add).  No
    capacity, so a row's routing does not depend on its batch-mates
    (padding rows route too, and take rows of their experts).

    While a profiler session records, the window log counts ``moe.routed``
    (T * k) and ``moe.routed_peak`` (E times the largest expert's rows,
    summed on the device): their ratio is 1 when every expert takes as many
    rows as any other.  Inside ``telemetry.tapping("moe.routes")`` each
    call hands over its (T, k) experts, so a check can hold a replay to
    the routes the program chose, and under ``"moe.router_in"`` the (T, d)
    tokens its router read, so a check can hold the router to its own
    input."""
    if sharded_ops().sharded(p):
        raise NotImplementedError("the dropless dispatch has no sharding rules")
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.num_experts_per_tok
    xt = x.reshape(t, d)
    telemetry.tap("moe.router_in", xt)
    top_e, top_w = moe_select(p, cfg, xt)
    telemetry.tap("moe.routes", top_e)
    flat = top_e.reshape(t * k)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    if telemetry.recording():
        telemetry.log_count("moe.routed", t * k)
        telemetry.log_count("moe.routed_peak", counts.max() * e)
    rows = xt[order // k]
    act = F.silu if cfg.act in ("silu", "geglu") else gelu
    h = act(expert_matmul(rows, p.w_gate, counts, offs, grouped)) * \
        expert_matmul(rows, p.w_up, counts, offs, grouped)
    y = expert_matmul(h, p.w_down, counts, offs, grouped)
    out = torch.empty_like(y)
    out[order] = y                                       # (token, choice) order
    contrib = out.reshape(t, k, d) * top_w[..., None].to(x.dtype)
    return contrib.sum(dim=1).reshape(b, s, d)


def moe_capacity_mlp(p: MoE, cfg: ModelConfig, x):
    """x: (B, S, d).  Tokens go to their top-k experts through a (G, E,
    cap, d) capacity buffer; overflow is dropped per group (Switch
    behaviour).  G is the number of batch shards under an active sharding
    context (``launch.sharding.num_batch_shards``; 1 outside one, or when
    it does not divide B): each group of B / G rows routes alone, with the
    capacity of its own (B / G) * S tokens, as each shard of the
    reference's batch does.  On a sharded model a rank's rows are one batch
    shard, so one group, and with the experts split over "model" the rank
    fills and runs only its own experts' slots (expert parallelism); the
    routing is computed whole on every rank and the combine summed over the
    model ranks.  The expert products are batched matmuls over every
    group's slots.  A token's k contributions are put back in (token,
    choice) order and summed over k, so the same batch gives the same bits
    on every run (no atomic scatter-add).

    While a profiler session records (``obs.telemetry.recording``), the
    window log counts ``moe.kept`` (summed on the device, no copy to the
    host) and ``moe.slots`` (G * E * cap)."""
    b, s, d = x.shape
    p, tp, e0, g = sharded_ops().moe(p)
    el = p.w_gate.shape[0]                               # the rank's experts
    if b % g:
        g = 1
    t = (b // g) * s                                    # tokens per group
    xt = x.reshape(g, t, d)
    cap = moe_capacity(cfg, t)
    routes = [moe_route(p, cfg, xt[i]) for i in range(g)]
    top_w = tp.enter(torch.stack([r[1] for r in routes]))  # (G, T, k)
    keep = torch.stack([r[2] for r in routes])
    # a slot of the rank's experts: its row in the group's (el * cap) rows
    at = torch.stack([r[3] for r in routes]) - e0 * cap
    keep = keep & (at >= 0) & (at < el * cap)
    # a group's slots follow the groups before it in the flat (G * el * cap) buffer
    base = (torch.arange(g, device=x.device) * (el * cap))[:, None, None]
    slot = at.clamp(0, el * cap - 1) + base
    k = top_w.shape[2]
    if telemetry.recording():
        telemetry.log_count("moe.kept", keep.sum())
        telemetry.log_count("moe.slots", g * el * cap)
    tok = torch.arange(g * t, device=x.device).reshape(g, t, 1).expand(-1, -1, k)
    # a dropped pair writes the scratch row past the buffer (the reference's
    # ``e * cap``), so the dispatch has the same shapes whatever is dropped
    buf = x.new_zeros((g * el * cap + 1, d))
    buf[torch.where(keep, slot, g * el * cap).reshape(-1)] = \
        tp.enter(xt).reshape(g * t, d)[tok.reshape(-1)]
    # (G, E, cap, d) -> (E, G * cap, d): one matmul an expert over every group
    buf = buf[:-1].reshape(g, el, cap, d).transpose(0, 1).reshape(el, g * cap, d)
    act = F.silu if cfg.act in ("silu", "geglu") else gelu
    h = act(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_buf = torch.bmm(h, p.w_down).reshape(el, g, cap, d).transpose(0, 1)
    out_buf = out_buf.reshape(g * el * cap, d)
    picked = out_buf[slot]                               # (G, T, k, d)
    contrib = torch.where(keep[..., None], picked, picked.new_zeros(()))
    contrib = contrib * top_w[..., None].to(x.dtype)
    return tp.reduce(contrib.sum(dim=2).reshape(b, s, d))
