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

On a sharded model (``train.sharded``) the moments are DTensors laid out
as their parameters, and the update runs on each rank's local shards: the
global norm sums each shard's squares once over the whole world
(:func:`sharded_global_norm`), and int8 compression scales each of the
reference's leaves by its largest |g| over every shard
(:func:`compress_sharded`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..models.model import STACKED
from . import sharded as SH


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


def _zeros_like(p) -> torch.Tensor:
    """f32 zeros of ``p``'s shape; of a DTensor, a DTensor of its layout
    whose shard alone is allocated."""
    z = torch.zeros(SH.local(p).shape, dtype=torch.float32, device=p.device)
    if not SH.is_dtensor(p):
        return z
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(z, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


def init_opt_state(params) -> dict:
    """Zero f32 moments for every leaf of ``params`` (a flat dict or a
    module's parameters) and step 0, on the leaves' device; a sharded
    parameter's moments are sharded as it is."""
    params = _tree(params)
    dev = next(iter(params.values())).device
    return {
        "m": {k: _zeros_like(p) for k, p in params.items()},
        "v": {k: _zeros_like(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _tree(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def sharded_global_norm(grads: dict, params: dict) -> torch.Tensor:
    """The global norm of gradients held as ``params``' local shards: each
    rank sums the squares of the shards it is the first replica of (index
    0 on every mesh axis that does not split the parameter), and the sums
    are added over the whole world."""
    total = None
    for k, g in grads.items():
        p = params[k]
        mesh = p.device_mesh
        if any(not pl.is_shard() and mesh.get_local_rank(i) != 0
               for i, pl in enumerate(p.placements)):
            continue
        ss = torch.sum(torch.square(g.float()))
        total = ss if total is None else total + ss
    g0 = next(iter(grads.values()))
    total = torch.zeros((), dtype=torch.float32, device=g0.device) if total is None else total
    return torch.sqrt(SH.all_reduce(total, None))


def reference_leaf(name: str) -> str:
    """The reference tree's leaf that parameter ``name`` is a slice of: it
    stacks a per-layer parameter over the layers (``layers``, ``enc``,
    ``blocks``), so ``layers.3.attn.wq`` is a slice of ``layers.attn.wq``."""
    top, _, rest = name.partition(".")
    if top in STACKED:
        return f"{top}.{rest.partition('.')[2]}"
    return name


def compress_sharded(grads: dict, mode: str) -> dict:
    """:func:`compress_grads` of local shards: int8 scales each of the
    reference's leaves by its largest |g| over every shard of every layer
    (a MAX all-reduce over the world), as the reference scales its stacked
    leaf."""
    if mode != "int8":
        return compress_grads(grads, mode)
    leaves = {k: reference_leaf(k) for k in grads}
    order = {r: i for i, r in enumerate(dict.fromkeys(leaves.values()))}
    peak = torch.stack([g.float().abs().max() for g in grads.values()])
    at = torch.tensor([order[leaves[k]] for k in grads], device=peak.device)
    scale = torch.zeros(len(order), device=peak.device).scatter_reduce(0, at, peak, "amax")
    dist.all_reduce(scale, op=dist.ReduceOp.MAX)
    scale = torch.clamp_min(scale, 1e-12) / 127.0
    out = {}
    for i, (k, g) in enumerate(grads.items()):
        q = torch.clamp(torch.round(g.float() / scale[at[i]]), -127, 127).to(torch.int8)
        out[k] = q.float() * scale[at[i]]
    return out


def _clip_scale(grads: dict, max_norm: float, norm=None):
    """(the factor clipping multiplies every gradient by, the global norm:
    ``norm`` when given, else the norm of ``grads``)"""
    norm = global_norm(grads) if norm is None else norm
    return torch.minimum(_f32(1.0, norm.device), max_norm / torch.clamp_min(norm, 1e-12)), norm


def clip_by_global_norm(grads: dict, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
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


def _schedule(state: dict, cfg: OptimizerConfig):
    """(the next step, its learning rate, the two bias corrections)"""
    step = state["step"] + 1
    dev = step.device
    sf = step.to(torch.float32)
    return (step, lr_schedule(step, cfg), 1 - torch.pow(_f32(cfg.b1, dev), sf),
            1 - torch.pow(_f32(cfg.b2, dev), sf))


def _leaf(k, p, g, m, v, lr, c1, c2, cfg: OptimizerConfig):
    """One leaf's AdamW step from its clipped gradient ``g``: (new
    parameter, new m, new v)."""
    gf = g.float()
    m = cfg.b1 * m + (1 - cfg.b1) * gf
    v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
    delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
    if p.ndim >= 2 or k.split(".")[0] in STACKED:  # decoupled decay, "matrices"
        delta = delta + cfg.weight_decay * p.detach().float()
    return (p.detach().float() - lr * delta).to(p.dtype), m, v


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptimizerConfig):
    """One AdamW step.  ``grads`` has ``params``' names (any float type).
    Returns (new params, new state, {"lr", "grad_norm"}); nothing passed in
    is changed: this is :func:`adamw_update_` on copies."""
    new_p = {k: p.detach().clone() for k, p in _tree(params).items()}
    new_s = {"m": {k: t.clone() for k, t in state["m"].items()},
             "v": {k: t.clone() for k, t in state["v"].items()}, "step": state["step"]}
    stats = adamw_update_(new_p, dict(grads), new_s, cfg)
    return new_p, new_s, stats


CHUNK = 1 << 24  # elements of a leaf that the in-place update takes at once


def adamw_update_(params, grads: dict, state: dict, cfg: OptimizerConfig,
                  norm=None) -> dict:
    """One AdamW step in place (what :func:`adamw_update` returns as new
    trees), one leaf at a time and a large leaf ``CHUNK`` elements of whole
    rows at a time (the same bits: the update is elementwise): each leaf's
    gradient leaves ``grads`` and its new parameter and moments overwrite
    the old ones in ``params`` and ``state`` before the next leaf.  So a
    step holds one set of moments, no second copy of the parameters or of
    the clipped gradients, and one chunk's f32 temporaries: an update into
    new trees holds over 20 bytes a bf16 parameter at its end, this one 12
    and a few hundred MB, which lets recurrentgemma-9b at full width, 8 layers and
    3.88 B parameters (a 1.05 B-parameter embedding among them), train on
    one 80 GB card.  ``norm``: the global norm, where the gradients are
    shards of it (:func:`sharded_global_norm`).  Returns {"lr",
    "grad_norm"}."""
    tree = _tree(params)
    step, lr, c1, c2 = _schedule(state, cfg)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm, norm)
    with torch.no_grad():
        for k, p in tree.items():
            g, m, v = grads.pop(k), state["m"][k], state["v"][k]
            rows = max(1, CHUNK // max(1, p[0].numel())) if p.ndim else 1
            for r in range(0, p.shape[0] if p.ndim else 1, rows):
                at = slice(r, r + rows) if p.ndim else ...
                new_p, new_m, new_v = _leaf(k, p[at], g[at] * scale.to(g.dtype), m[at],
                                            v[at], lr, c1, c2, cfg)
                m[at], v[at], p[at] = new_m, new_v, new_p
            del g
    state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}
