"""Plain PyTorch version of flash attention (the reference's
``flash_attention_ref``): exact softmax attention with causal and window
masks, in f32 (in f64 for f64 inputs, which the gradient checks
differentiate), output in q's type."""
import torch


def flash_attention_ref(q, k, v, causal=True, window=0):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct).reshape(b, hkv, g, sq, d)
    s = torch.einsum("bngsd,bntd->bngst", qf, k.to(ct)) * d**-0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qp >= kp
    if window > 0:
        mask = mask & (qp - kp < window)
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=ct, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bngst,bntd->bngsd", p, v.to(ct))
    return o.reshape(b, hq, sq, d).to(q.dtype)
