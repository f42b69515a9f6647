"""``chip_smoke.py`` phase 11b's ``rwkv6-1.6b`` steps run twice from the same
seed: once through K6 and its backward kernel, once with the scan's plain
PyTorch version (``kernels/rwkv6_scan/ref.py``) differentiated by autograd
in its place.  The loss on phase 11b's repeated batch swings from step to
step; if the two series agree within bf16 rounding, the swing comes from
the optimizer and the data, not from the kernels.

    python scripts/rwkv6_loss_check.py                # one card: the full model, 16 x 128
    python scripts/rwkv6_loss_check.py --device cpu   # rehearsal: the reduced config

Prints one JSON line: each run's losses, grad norms and K6 launches, and
each step's |difference| over the trainer's bf16 rule (6e-2 of the
kernel run's loss), with the card's name and power limit.  Then, at the
initial weights: every parameter's gradient through K6, through the plain
scan at f32 and through the plain scan at f64 (the leaves each pair
differs most on), and each layer's scan alone on the operands the model
hands it (its (B, T, H, hd) views), its backward through K6's kernel and
through the plain version's f32 autograd against the plain version's f64
autograd, for one seeded cotangent.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(size, device, plain):
    import chip_smoke
    import repro_torch.models.recurrent as R
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.train import make_train_step

    kernel = R.rwkv6_scan
    R.rwkv6_scan = rwkv6_scan_ref if plain else kernel
    try:
        cfg, params, opt, ocfg, batch_at = chip_smoke._train_setup(
            size, device, name="rwkv6-1.6b", batch=16 if size.full else None)
        step, data = make_train_step(cfg, ocfg), batch_at(0)
        cuda_lib.reset_launches()
        losses, norms = [], []
        for _ in range(chip_smoke.RECURRENT_TRAIN_STEPS):
            params, opt, m = step(params, opt, data)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    finally:
        R.rwkv6_scan = kernel
    del params, opt
    chip_smoke._free()
    return {"scan": "plain autograd" if plain else "K6 + its backward", "losses": losses,
            "grad_norms": norms, "launches": launches}


def _wide_scan(r, k, v, w, u):
    """The plain scan computed in f64 (its operands widened, its output
    rounded to f32): a more accurate version of the same function."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    return rwkv6_scan_ref(*(x.double() for x in (r, k, v, w, u))).float()


def gradients(size, device):
    """At the initial weights: every leaf's gradient with the scan through
    K6, through the plain version at f32 and through the plain version at
    f64 (each pair's leaves that differ most); and each layer's scan alone
    on the operands the model hands it, its backward through the kernel and
    the plain f32 version against the plain f64 version, for one seeded
    cotangent."""
    import chip_smoke
    import repro_torch.models.recurrent as R
    import torch
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.train import loss_and_grads

    kernel, seen = R.rwkv6_scan, []

    def recording(*ops):
        seen.append([x.detach() for x in ops])
        return kernel(*ops)

    out = {}
    for name, fn in (("kernel", recording), ("plain f32", rwkv6_scan_ref),
                     ("plain f64", _wide_scan)):
        R.rwkv6_scan = fn
        try:
            cfg, params, _, _, batch_at = chip_smoke._train_setup(
                size, device, name="rwkv6-1.6b", batch=16 if size.full else None,
                with_opt=False)
            loss, grads = loss_and_grads(cfg, params, batch_at(0))
        finally:
            R.rwkv6_scan = kernel
        out[name] = (float(loss), {k: g.float() for k, g in grads.items()})
        del params
        if name == "kernel":
            seen = seen[:cfg.num_layers]  # the first forward's (remat runs each twice)

    def apart(a, b):
        ga, gb = out[a][1], out[b][1]
        rows = sorted(((float((ga[k] - gb[k]).abs().max()
                              / gb[k].abs().max().clamp_min(1e-30)), k) for k in ga),
                      reverse=True)
        return [{"leaf": k, "max_diff_over_max": r} for r, k in rows[:5]]

    # each layer's scan alone, for one seeded cotangent
    ops0 = seen[0][0]
    dout = torch.randn(ops0.shape, device=ops0.device,
                       generator=torch.Generator(device=ops0.device).manual_seed(0))

    def backward(fn, ops, wide):
        xs = [(x.detach().double() if wide else x.detach()).requires_grad_() for x in ops]
        torch.autograd.backward(fn(*xs), dout.double() if wide else dout)
        return [x.grad.double() for x in xs]

    layers = []
    for ops in seen:
        truth = backward(rwkv6_scan_ref, ops, True)
        row = {}
        for label, fn in (("kernel", rwkv6_scan), ("plain f32", rwkv6_scan_ref)):
            row[label] = max(float((a - t).abs().max() / t.abs().max())
                             for a, t in zip(backward(fn, ops, False), truth))
        layers.append(row)
    return {"loss": {k: v[0] for k, v in out.items()},
            "grad_norm": {k: float(torch.sqrt(sum(g.square().sum() for g in v[1].values())))
                          for k, v in out.items()},
            "kernel vs plain f32": apart("kernel", "plain f32"),
            "kernel vs plain f64": apart("kernel", "plain f64"),
            "plain f32 vs plain f64": apart("plain f32", "plain f64"),
            "layer_scan_shape": list(ops0.shape),
            "layer_scan_backward_worst_err_over_max": layers}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke

    card = None
    if args.device == "cuda":
        from repro_torch.kernels import cuda_lib

        cuda_lib.build()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    size = chip_smoke.TRAIN_FULL if args.device == "cuda" else chip_smoke.TRAIN_REHEARSAL
    kern, plain = run(size, args.device, False), run(size, args.device, True)
    ratio = [abs(a - b) / (chip_smoke.BF16_RULE * abs(a))
             for a, b in zip(kern["losses"], plain["losses"])]
    print(json.dumps({"card": card, "kernels": kern, "plain": plain,
                      "difference_over_bf16_rule": ratio,
                      "gradients": gradients(size, args.device)}), flush=True)


if __name__ == "__main__":
    main()
