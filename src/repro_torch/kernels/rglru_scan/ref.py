"""Plain PyTorch versions of the RG-LRU scan (the reference's
``rglru_scan_ref``) and of its backward: the diagonal recurrence step by
step from zero, and its reverse."""
import torch


def _ct(x):
    """The computation type: f32 (f64 for f64 inputs, which the gradient
    checks take)."""
    return torch.promote_types(x.dtype, torch.float32)


def rglru_scan_ref(a, g):
    """a, g: (B, T, R).  h_t = a_t h_{t-1} + g_t, h_0 = 0.  Returns (B, T, R)
    f32."""
    af, gf = a.to(_ct(a)), g.to(_ct(a))
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + gf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_scan_bwd_ref(a, h, dout):
    """(da, dg) of the scan for the cotangent ``dout`` of its output ``h``
    (all (B, T, R)): Lambda_t = dout_t + a_{t+1} Lambda_{t+1} from the last
    step down, dg_t = Lambda_t, da_t = Lambda_t h_{t-1} (h_{-1} = 0)."""
    ct = _ct(a)
    af, hf, df = a.to(ct), h.to(ct), dout.to(ct)
    lam = torch.zeros_like(af[:, 0])
    a_next = torch.zeros_like(lam)
    das, dgs = [], []
    for t in reversed(range(af.shape[1])):
        lam = a_next * lam + df[:, t]
        dgs.append(lam)
        das.append(lam * hf[:, t - 1] if t > 0 else torch.zeros_like(lam))
        a_next = af[:, t]
    return torch.stack(das[::-1], dim=1), torch.stack(dgs[::-1], dim=1)
