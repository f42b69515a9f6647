"""Plain PyTorch versions of the RWKV6 scan (the reference's
``rwkv6_scan_ref``) and of its backward: the recurrence step by step from
a zero state, and its reverse."""
import torch


def _ct(x):
    """The computation type: f32 (f64 for f64 inputs, which the gradient
    checks take)."""
    return torch.promote_types(x.dtype, torch.float32)


def rwkv6_scan_ref(r, k, v, w, u):
    """r, k, v, w: (B, H, T, hd) of any float type and strides, widened to
    f32 as the kernel widens them; u: (H, hd).  Returns (B, H, T, hd) f32."""
    ct = _ct(r)
    rf, kf, vf, wf = (x.to(ct) for x in (r, k, v, w))
    b, h, t, hd = rf.shape
    uf = u.to(ct)[None, :, :, None]
    s = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device)
    outs = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, i], s + uf * kv))
        s = wf[:, :, i, :, None] * s + kv
    return torch.stack(outs, dim=2)


def rwkv6_scan_bwd_ref(r, k, v, w, u, dout):
    """(dr, dk, dv, dw, du) of the scan for the cotangent ``dout`` (B, H,
    T, hd) of its output, in f32 (f64 for f64 inputs).  With S_t the state
    after step t (S_{-1} = 0) and G_t the gradient by S_t (G_{T-1} = 0), from
    the last step down:
    dr_t = dout_t S_{t-1}^T + u k_t (dout_t . v_t),
    dk_t = G_t v_t + u r_t (dout_t . v_t),
    dv_t = G_t^T k_t + dout_t sum_i r_t u k_t,
    dw_t = rowsum(G_t * S_{t-1}),  G_{t-1} = diag(w_t) G_t + r_t^T dout_t,
    du = sum over batch (after time) of r_t k_t (dout_t . v_t)."""
    ct = _ct(r)
    rf, kf, vf, wf, df = (x.to(ct) for x in (r, k, v, w, dout))
    b, h, t, hd = rf.shape
    uf = u.to(ct)[None]
    s = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device)
    states = []
    for i in range(t):
        states.append(s)
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i, None, :]
    g = torch.zeros_like(s)
    du = torch.zeros((b, h, hd), dtype=ct, device=r.device)
    grads = [[None] * t for _ in range(4)]
    for i in reversed(range(t)):
        ri, ki, vi, wi, di = (x[:, :, i] for x in (rf, kf, vf, wf, df))
        dd = (di * vi).sum(-1, keepdim=True)
        beta = (ri * uf * ki).sum(-1, keepdim=True)
        sp = states[i]
        grads[0][i] = torch.einsum("bhj,bhij->bhi", di, sp) + uf * ki * dd
        grads[1][i] = torch.einsum("bhij,bhj->bhi", g, vi) + uf * ri * dd
        grads[2][i] = torch.einsum("bhij,bhi->bhj", g, ki) + di * beta
        grads[3][i] = (g * sp).sum(-1)
        du = du + ri * ki * dd
        g = wi[..., :, None] * g + ri[..., :, None] * di[..., None, :]
    dr, dk, dv, dw = (torch.stack(x, dim=2) for x in grads)
    return dr, dk, dv, dw, du.sum(0)
