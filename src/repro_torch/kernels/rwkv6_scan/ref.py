"""Plain PyTorch version of the RWKV6 scan (the reference's
``rwkv6_scan_ref``): the recurrence step by step from a zero state."""
import torch


def rwkv6_scan_ref(r, k, v, w, u):
    """r, k, v, w: (B, H, T, hd) of any float type and strides, widened to
    f32 as the kernel widens them; u: (H, hd).  Returns (B, H, T, hd) f32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    b, h, t, hd = rf.shape
    uf = u.float()[None, :, :, None]
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, i], s + uf * kv))
        s = wf[:, :, i, :, None] * s + kv
    return torch.stack(outs, dim=2)
