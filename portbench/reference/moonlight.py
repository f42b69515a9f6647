"""Plain forward of Moonlight-16B-A3B in f32, to the last position's YES /
NO logits, for whole scorer batches.

The layer equations, written from the published model (Moonlight-16B-A3B,
arXiv:2502.16982, ``model_type`` deepseek_v3: DeepSeek-V3's blocks,
arXiv:2412.19437) and its config.json:

    x   = embed[tokens]
    x  += MLA(RMS(x; ln1))
    x  += FFN(RMS(x; ln2))       layer 0: SwiGLU of width d_ff;
                                 the rest: routed experts + shared expert
    logits = RMS(x_last; ln_f) @ head, at the YES and NO tokens

MLA (no q LoRA: ``q_lora_rank`` is null), per head h:

    q_h = x W_q                  [q_nope (nope) | q_pe (rope)]
    [c | k_pe] = x W_kv_a,  c = RMS(c; kv_norm)
    [k_nope_h | v_h] = c W_kv_b
    q_pe, k_pe rotated by RoPE (theta) over adjacent pairs (2i, 2i + 1),
    k_pe one for all heads
    s = (q_nope . k_nope + q_pe . k_pe) / sqrt(nope + rope), causal
    out = concat_h softmax(s) v_h  @ W_o

MoE: s = sigmoid(x W_r) in f32; the top k experts by s + b (the
correction bias, for selection only; one group, so no group limit); their
weights s / sum(s) (``norm_topk_prob``; the sum + 1e-20) times
``routed_scaling_factor``; out = sum_j w_j SwiGLU_j(x) + SwiGLU_shared(x),
dropless: every routed (token, expert) pair runs, one loop an expert.  No
capacity is shared, so a row's result does not depend on the rows batched
with it: here the batch groups the work and is not part of the
computation (unlike the capacity-dropping MoE of ``olmoe.py``).

RMS(x; w) = x / sqrt(mean(x^2) + eps) * (1 + w); the published norms are
``w * x / rms`` with w initialised to 1, so the zero ``w`` of random
weights is the published initial norm.  Departures from the published
model: random weights (the correction bias too, drawn at a scale that
changes the top k of many tokens); no multi-token prediction (the config
has none).

Forced routes.  Routing is a discrete choice: where two experts' scores
lie within rounding of each other, a bf16 forward and this f32 one pick
differently, and at random weights, whose router scores crowd the top k,
each such flip moves a token by a whole expert's output, which 26 layers
compound until the two forwards no longer compare.  So ``routes`` (the
experts another forward chose, one (T, k) tensor an MoE layer) can be laid
over this forward's choice: the forced experts are weighed by this
router's own scores, and for every token the ``margin`` by which they fall
short of its own top k (its k-th score + bias less the least of the forced
experts', 0 where they are its own top k) is returned, so the choice is
judged apart from the arithmetic.  :func:`route` alone judges another
router's choice on that router's own input the same way.

Weights are tensors named as the served model's parameters
(``layers.<l>.attn.wq``, ``layers.<l>.moe.shared.w_up``, ...), read one
layer at a time and widened to f32; TF32 off.  ``fp8=True`` is the control:
each product's weight (per output column) and input (per row) rounded to
float8 e4m3, one precision below the served bf16, the router's too (its
margins then measure the fp8 router's choice against the f32 router's on
the same input).

Imports nothing of the program.
"""
from __future__ import annotations

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


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x: (..., S, r), position t at row t; pairs (2i, 2i + 1) rotated by
    t / theta**(2i / r), in place of the pair."""
    r, s = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, r, 2, dtype=torch.float64) / r))
    ang = (torch.arange(s, dtype=torch.float64)[:, None] * freqs).to(torch.float32)
    cos, sin = ang.cos().to(x.device), ang.sin().to(x.device)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).flatten(-2)


def mla(h, w, m, fp8=False):
    """Latent attention of (B, S, d) inputs; ``w``: one layer's weights."""
    b, s, _ = h.shape
    nh, nope, rp, dv = (m["num_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"])
    kvl, eps = m["kv_lora_rank"], m["norm_eps"]
    q = _mm(h, w["attn.wq"], fp8).view(b, s, nh, nope + rp).transpose(1, 2)
    kv_a = _mm(h, w["attn.wkv_a"], fp8)
    c = rms(kv_a[..., :kvl], w["attn.kv_norm"], eps)
    k_pe = rope(kv_a[..., kvl:], m["rope_theta"])[:, None]          # (B, 1, S, rope)
    kv = _mm(c, w["attn.wkv_b"], fp8).view(b, s, nh, nope + dv).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = rope(q[..., nope:], m["rope_theta"])
    scores = (q[..., :nope] @ k_nope.transpose(-1, -2)
              + q_pe @ k_pe.transpose(-1, -2)) * (nope + rp) ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = (p @ v).transpose(1, 2).reshape(b, s, nh * dv)
    return _mm(o, w["attn.wo"], fp8)


def swiglu(x, w, pre, fp8=False):
    return _mm(F.silu(_mm(x, w[pre + "w_gate"], fp8)) * _mm(x, w[pre + "w_up"], fp8),
               w[pre + "w_down"], fp8)


def route(x, w, m, forced=None, fp8=False):
    """(T, d) tokens -> (experts (T, k), weights (T, k), margins (T,)) by the
    sigmoid router, the bias choosing and the scores weighing.  The experts
    taken are ``forced`` (T, k) where given, else the router's own, with
    ``fp8`` from its product at fp8; a token's margin is how far they fall
    short of the f32 router's own top k (0 where they are its top k)."""
    k = m["num_experts_per_tok"]

    def choose(scores):
        return scores + w["moe.router_bias"] if "moe.router_bias" in w else scores

    scores = torch.sigmoid(x @ w["moe.router"])
    choice = choose(scores)
    own = torch.topk(choice, k, dim=-1).indices
    if forced is not None:
        sel = forced.to(x.device).long()
    elif fp8:
        scores = torch.sigmoid(_mm(x, w["moe.router"], True))
        sel = torch.topk(choose(scores), k, dim=-1).indices
    else:
        sel = own
    margin = (choice.gather(-1, own).min(-1).values
              - choice.gather(-1, sel).min(-1).values).clamp_min(0)
    wts = scores.gather(-1, sel)
    if m.get("norm_topk_prob", True):
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    return sel, wts * m.get("routed_scaling_factor", 1.0), margin


def moe(h, w, m, fp8=False, forced=None):
    """Routed experts (dropless, an expert at a time) + the shared expert;
    returns (out, margins, experts) (:func:`route`)."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    sel, wts, margin = route(x, w, m, forced, fp8)
    out = torch.zeros_like(x)
    for ex in range(m["num_experts"]):
        tok, choice = torch.nonzero(sel == ex, as_tuple=True)
        if len(tok) == 0:
            continue
        xe = x[tok]
        y = F.silu(_mm(xe, w["moe.w_gate"][ex], fp8)) * _mm(xe, w["moe.w_up"][ex], fp8)
        out.index_add_(0, tok, _mm(y, w["moe.w_down"][ex], fp8) * wts[tok, choice, None])
    if "moe.shared.w_gate" in w:
        out = out + swiglu(x, w, "moe.shared.", fp8)
    return out.view(b, s, d), margin, sel


def layer(x, w, m, fp8=False, forced=None):
    """One layer; returns (x, the MoE's margins and experts, or None, None)."""
    eps = m["norm_eps"]
    x = x + mla(rms(x, w["ln1"], eps), w, m, fp8)
    h = rms(x, w["ln2"], eps)
    if "moe.router" not in w:
        return x + swiglu(h, w, "mlp.", fp8), None, None
    out, margin, sel = moe(h, w, m, fp8, forced)
    return x + out, margin, sel


def layer_weights(weights: dict, i: int) -> dict:
    pre = f"layers.{i}."
    return {n[len(pre):]: t.float() for n, t in weights.items() if n.startswith(pre)}


@torch.no_grad()
def yes_no_logits(weights: dict, model: dict, batches: list, yes: int, no: int,
                  fp8: bool = False, device="cuda", routes=None, margins=None,
                  chose=None) -> list:
    """The (YES, NO) logits at each row's last position, f64 numpy (B, 2),
    one array a batch; ``batches`` are (tokens (B, S), last (B,)) pairs,
    run together layer by layer.  ``routes``: for each batch, the forced
    experts of each MoE layer in order (:func:`route`).  ``margins``, a
    list, receives for each batch a (MoE layers, B * S) f64 numpy array of
    the margins of the experts each layer ran (:func:`route`: the forced
    ones', or the fp8 router's).  ``chose``, a list, receives for each
    batch the experts each MoE layer ran, (B * S, k) tensors in order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    xs = [weights["embed"][torch.as_tensor(t, device=dev)].float() for t, _ in batches]
    moe_i = 0
    got = [[] for _ in batches]
    ran = [[] for _ in batches]
    for i in range(model["num_layers"]):
        w = layer_weights(weights, i)
        is_moe = "moe.router" in w
        for j, x in enumerate(xs):
            forced = routes[j][moe_i] if routes is not None and is_moe else None
            xs[j], margin, sel = layer(x, w, model, fp8, forced)
            if is_moe:
                got[j].append(margin)
                ran[j].append(sel)
        moe_i += is_moe
        del w
    if margins is not None:
        margins.extend(torch.stack(g).double().cpu().numpy() for g in got)
    if chose is not None:
        chose.extend(ran)
    head = weights["head"][:, [yes, no]].float()
    ln_f = weights["ln_f"].float()
    out = []
    for x, (_, last) in zip(xs, batches):
        rows = torch.arange(x.shape[0], device=dev)
        h = rms(x[rows, torch.as_tensor(last, device=dev)], ln_f, model["norm_eps"])
        out.append(_mm(h, head, fp8).double().cpu().numpy())
    return out


def yes_probs(weights: dict, model: dict, batches: list, yes: int, no: int,
              fp8: bool = False, device="cuda", routes=None, margins=None,
              chose=None) -> list:
    """P(YES) against NO at each row's last position, one array a batch
    (``routes``, ``margins``, ``chose``: :func:`yes_no_logits`)."""
    out = []
    for lg in yes_no_logits(weights, model, batches, yes, no, fp8, device, routes, margins,
                            chose):
        z = lg - lg.max(axis=1, keepdims=True)
        e = np.exp(z)
        out.append(e[:, 0] / e.sum(axis=1))
    return out
