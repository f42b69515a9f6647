"""AdamW with a warmup + cosine schedule, global-norm clipping and gradient
compression, as plain functions on tensors (the reference's
``train/optimizer.py``), in the reference's order of operations: f32
moments, decay on matrices only, the update in f32 and then a cast to the
parameter's type.  ``torch.optim.AdamW`` is not used: it decays every
tensor and orders the update differently.

A tree here is a flat ``{name: tensor}`` dict (a model's
``named_parameters()``); the optimizer state is ``{"m": tree, "v": tree,
"step": int32 scalar}``, the reference's layout.

"Matrices only" is the reference's rule as its tree shapes it: a leaf
decays when it has two axes or more there, and the reference stacks every
per-layer parameter over the layers (``layers``, ``enc``, ``blocks``), so
a layer's vectors (norm scales, biases, RWKV's mixes) decay too.  The port
keeps a layer's parameters unstacked and decays a leaf under those names
whatever its axes, so the two take the same step.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.model import STACKED


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient compression applied before the (data-parallel) all-reduce:
    # "none" | "bf16" | "int8" (symmetric per-tensor quantisation)
    grad_compression: str = "none"


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor or int), f32."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, dev) * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    """Zero f32 moments for every leaf of ``params`` (a flat dict or a
    module's parameters) and step 0, on the leaves' device."""
    params = _tree(params)
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _tree(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, norm.device), max_norm / torch.clamp_min(norm, 1e-12))
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _int8(g):
    gf = g.float()
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    qg = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return qg.float() * scale


def compress_grads(grads: dict, mode: str) -> dict:
    """Lossy gradient compression: bf16 or per-tensor symmetric int8, both
    back in f32 for the update."""
    if mode == "none":
        return grads
    if mode == "bf16":
        return {k: g.to(torch.bfloat16).float() for k, g in grads.items()}
    if mode == "int8":
        return {k: _int8(g) for k, g in grads.items()}
    raise ValueError(mode)


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptimizerConfig):
    """One AdamW step.  ``grads`` has ``params``' names (any float type).
    Returns (new params, new state, {"lr", "grad_norm"}); nothing is
    updated in place."""
    params = _tree(params)
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    dev = step.device
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(_f32(cfg.b1, dev), sf)
    c2 = 1 - torch.pow(_f32(cfg.b2, dev), sf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float()
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * gf
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * gf * gf
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.ndim >= 2 or k.split(".")[0] in STACKED:  # decoupled decay, "matrices"
            delta = delta + cfg.weight_decay * p.detach().float()
        new_p[k] = (p.detach().float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"lr": lr, "grad_norm": gnorm}
