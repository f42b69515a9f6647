"""Plain PyTorch version of the RG-LRU scan (the reference's
``rglru_scan_ref``): the diagonal recurrence step by step from zero."""
import torch


def rglru_scan_ref(a, g):
    """a, g: (B, T, R).  h_t = a_t h_{t-1} + g_t, h_0 = 0.  Returns (B, T, R)
    f32."""
    af, gf = a.float(), g.float()
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + gf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
