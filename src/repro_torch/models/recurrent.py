"""Recurrent sequence mixers: RWKV6 (Finch) time/channel mix and the RG-LRU
(RecurrentGemma/Griffin) block (the reference's ``models/recurrent.py``).

The mixers take and return the reference's state: ``rwkv_time_mix`` the
(B, H, hd, hd) f32 matrix ``s`` beside the token shift's last input,
``rglru_mix`` the (B, r) f32 ``h`` beside the causal conv's last inputs.
Given no state (``None``), a mixer runs the full sequence from zeros through
its scan op, ``kernels.rwkv6_scan`` (K6) or ``kernels.rglru_scan`` (K7),
where the reference runs ``lax.scan``; the kernels return no final state, so
neither does the mixer (``forward`` discards it, as the reference's does).
Given a state, it runs the recurrence's update step by step in plain torch,
as the reference does in ``jnp`` for decode (T = 1): the kernels take no
initial state.

On a sharded model (``train.sharded``) the time mix splits its heads, the
channel mix its ``d_ff`` and the RG-LRU its ``rnn`` channels over the
"model" axis where their specs do: the scans run on the rank's heads and
channels, the row-parallel outputs are summed over the model ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru_scan import rglru_scan
from ..kernels.rwkv6_scan import rwkv6_scan
from .config import ModelConfig
from .layers import dense_init, dtype_of, full, gelu, param, sharded_ops


# ----------------------------------------------------------------------------
# RWKV6
# ----------------------------------------------------------------------------

class TimeMix(nn.Module):
    """``rwkv_params()["time"]``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt, f32 = dtype_of(cfg), torch.float32
        d, hd, lora = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_decay_lora
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, param(full(gen, (d,), 0.5, dt)))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, param(dense_init(gen, (d, d), dt)))
        # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x A) B))
        self.decay_w0 = param(full(gen, (d,), -6.0, f32))
        self.decay_a = param(dense_init(gen, (d, lora), dt))
        self.decay_b = param(dense_init(gen, (lora, d), dt, scale=0.01))
        self.bonus_u = param(dense_init(gen, (d // hd, hd), f32, scale=0.1))
        self.ln_x = param(full(gen, (d,), 1.0, f32))


class ChannelMix(nn.Module):
    """``rwkv_params()["channel"]``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt, d = dtype_of(cfg), cfg.d_model
        self.mu_k = param(full(gen, (d,), 0.5, dt))
        self.mu_r = param(full(gen, (d,), 0.5, dt))
        self.w_k = param(dense_init(gen, (d, cfg.d_ff), dt))
        self.w_v = param(dense_init(gen, (cfg.d_ff, d), dt))
        self.w_r = param(dense_init(gen, (d, d), dt))


def _token_shift(x, last):
    """x: (B, T, d); last: (B, d) value preceding x[:, 0]."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_steps(r, k, v, w, u, s):
    """The RWKV6 recurrence from state ``s`` (B, H, hd, hd), f32, one step
    at a time (the reference's ``step``).  r, k, v, w: (B, T, H, hd).
    Returns (out (B, T, H, hd) f32, the final state)."""
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (z[:, t].float() for z in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(p: TimeMix, cfg: ModelConfig, x, state, last_x):
    """RWKV6 attention substitute.

    x: (B, T, d); state: (B, H, hd, hd) f32, or None for zeros (the full
    sequence through K6, and no final state back); last_x: (B, d).
    Returns (out, new_state, new_last_x)."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    p, tp = sharded_ops().time_mix(p, cfg)
    prev = _token_shift(x, last_x)

    def mix(mu):
        return x + (prev - x) * mu

    # split: r, k, g column-parallel; w_v row-parallel by its spec, its
    # partial sums reduce-scattered onto the rank's heads; the decay and
    # the bonus computed whole and sliced
    r = (tp.enter(mix(p.mu_r)) @ p.w_r).reshape(b, t, -1, hd)
    k = (tp.enter(mix(p.mu_k)) @ p.w_k).reshape(b, t, -1, hd)
    v = tp.reduce_scatter(tp.split(mix(p.mu_v), -1) @ p.w_v, -1).reshape(b, t, -1, hd)
    g = F.silu(tp.enter(mix(p.mu_g)) @ p.w_g)
    dec = p.decay_w0 + torch.tanh(mix(p.mu_w) @ p.decay_a) @ p.decay_b
    w = tp.split(torch.exp(-torch.exp(dec.float())), -1).reshape(b, t, -1, hd)
    u = tp.split(p.bonus_u, 0)
    if state is None:
        # (B, H, T, hd) views of the (B, T, H, hd) projections, in the
        # model's type: the kernel reads them through their strides, widens
        # to f32, and writes its output in r's layout
        out = rwkv6_scan(*(z.transpose(1, 2) for z in (r, k, v, w)), u)
        out = out.transpose(1, 2)  # (B, T, H, hd)
    else:
        out, state = _rwkv_steps(r, k, v, w, u, state)
    # per-head group norm (ln_x), population variance as jnp.var
    mu_ = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu_) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, t, -1) * tp.split(p.ln_x, 0)
    out = tp.reduce((out.to(x.dtype) * g) @ p.w_o)
    return out, state, x[:, -1, :]


def rwkv_channel_mix(p: ChannelMix, cfg: ModelConfig, x, last_x):
    """Split: ``w_k`` and ``w_r`` column-parallel, ``w_v`` row-parallel; the
    gate meets the value on the rank's channels, gathered whole after."""
    p, tp = sharded_ops().channel_mix(p)
    prev = _token_shift(x, last_x)
    xk = x + (prev - x) * p.mu_k
    xr = x + (prev - x) * p.mu_r
    k = torch.square(F.relu(tp.enter(xk) @ p.w_k))
    kv = tp.reduce_scatter(k @ p.w_v, -1)
    return tp.gather(torch.sigmoid(tp.enter(xr) @ p.w_r) * kv, -1), x[:, -1, :]


def rwkv_state_init(cfg: ModelConfig, batch: int, device):
    hd = cfg.rwkv_head_dim
    h = cfg.d_model // hd
    dt = dtype_of(cfg)
    return {
        "s": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "last_time": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
        "last_chan": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
    }


# ----------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ----------------------------------------------------------------------------

RG_LRU_C = 8.0


class RGLRU(nn.Module):
    """``rglru_params``; the parameter the reference calls ``lambda`` is
    registered under that name."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt, f32 = dtype_of(cfg), torch.float32
        d, r = cfg.d_model, cfg.rnn_width
        self.w_x = param(dense_init(gen, (d, r), dt))
        self.w_y = param(dense_init(gen, (d, r), dt))
        self.conv_w = param(dense_init(gen, (cfg.conv_width, r), dt, scale=0.5))
        self.conv_b = param(full(gen, (r,), 0.0, dt))
        self.w_gate_a = param(dense_init(gen, (r, r), dt))
        self.b_gate_a = param(full(gen, (r,), 0.0, f32))
        self.w_gate_x = param(dense_init(gen, (r, r), dt))
        self.b_gate_x = param(full(gen, (r,), 0.0, f32))
        lam = torch.from_numpy(np.linspace(0.65, 0.999, r).astype(np.float32))
        self.register_parameter("lambda", param(lam.to(gen.device)))
        self.w_o = param(dense_init(gen, (r, d), dt))


def _causal_conv(x, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv via shifted adds, in the reference's order.

    x: (B, T, r); conv_w: (W, r); conv_state: (B, W-1, r) previous inputs.
    Returns (out, new_conv_state)."""
    b, t, r = x.shape
    w = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((b, w - 1, r), dtype=x.dtype, device=x.device)
    ext = torch.cat([conv_state, x], dim=1)  # (B, T+W-1, r)
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + ext[:, i:i + t, :] * conv_w[w - 1 - i]
    new_state = ext[:, -(w - 1):, :] if w > 1 else conv_state
    return out + conv_b, new_state


def rglru_mix(p: RGLRU, cfg: ModelConfig, x, h0, conv_state):
    """Griffin recurrent block.

    x: (B, T, d); h0: (B, r) f32, or None for zeros (the full sequence
    through K7, and no final h back); conv_state: (B, W-1, r), or None for
    zeros.  Returns (out, h_T, new_conv_state).  Split over "model": the
    rank's ``rnn`` channels; the gates read every channel of the conv's
    output (gathered) and write the rank's."""
    p, tp = sharded_ops().rglru(p)
    xin = tp.enter(x)
    y = gelu(xin @ p.w_y)
    u = xin @ p.w_x
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b, conv_state)
    whole = tp.gather(u, -1, bwd="sum")
    rg = torch.sigmoid((whole @ p.w_gate_a).float() + p.b_gate_a)
    ig = torch.sigmoid((whole @ p.w_gate_x).float() + p.b_gate_x)
    log_a = -RG_LRU_C * F.softplus(getattr(p, "lambda")) * rg  # (B, T, r) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        ig * u.float()
    )
    if h0 is None:
        hs = rglru_scan(a, gated)  # (B, T, r) f32
        h_t = None
    else:
        steps = []
        h_t = h0
        for t in range(x.shape[1]):
            h_t = a[:, t] * h_t + gated[:, t]
            steps.append(h_t)
        hs = torch.stack(steps, dim=1)
    return tp.reduce((y * hs.to(x.dtype)) @ p.w_o), h_t, conv_state


def rglru_state_init(cfg: ModelConfig, batch: int, device):
    return {
        "h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                            dtype=dtype_of(cfg), device=device),
    }
