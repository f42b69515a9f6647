"""Manual data-parallel train step with a *compressed* gradient all-reduce
(the reference's ``train/manual_dp.py``).

Each rank of a multi-process mesh computes the loss and its gradients on
its slice of the batch; the gradients are quantised (int8 symmetric per
leaf, or bf16) *before* ``torch.distributed.all_reduce``, cutting the
DP-gradient collective's bytes, at the cost of bounded quantisation error;
then every rank applies the same AdamW update to its replica.

Wire formats, per mode (``OptimizerConfig.grad_compression``):

* ``"none"``: an f32 SUM;
* ``"bf16"``: a bf16 SUM, widened to f32 after;
* ``"int8"``: a MAX all-reduce of the per-leaf scales (the reference's
  ``pmax``: a shared scale, so the reduced value is exact with respect to
  the quantised terms), then the int8 quantisation widened to int32 on the
  wire (an int8 sum of N ranks would overflow) and SUMmed, times the scale.
  A leaf is the reference's: its tree stacks each per-layer parameter over
  the layers (``layers``, ``enc``, ``blocks``), so the port's layers share
  one scale a parameter name (``layers.3.attn.wq`` and ``layers.5.attn.wq``
  share ``layers.attn.wq``'s).

Every leaf travels in one flat buffer a collective, so a step makes two
all-reduces (three in int8), the loss's included.  ``step.wire`` records
what the last step's all-reduces received: ``{"<op> <dtype>": elements}``.

Scope: pure DP over the batch axes (the model is replicated on every rank),
as the reference's.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from .optimizer import OptimizerConfig, adamw_update_, reference_leaf
from .train_loop import loss_and_grads

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(t: torch.Tensor, op: str, group, wire: collections.Counter) -> torch.Tensor:
    wire[f"{op} {str(t.dtype).removeprefix('torch.')}"] += t.numel()
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def _flat(tensors, dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    out, at = {}, 0
    for k, t in like.items():
        out[k] = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
    return out


def _quantise_all_reduce(grads: dict, group, mode: str, wire) -> dict:
    """The SUM over the group's ranks of each gradient, with on-the-wire
    compression; f32 out."""
    if mode == "none":
        return _unflat(_all_reduce(_flat(grads.values(), torch.float32), "sum", group, wire),
                       grads)
    if mode == "bf16":
        s = _all_reduce(_flat(grads.values(), torch.bfloat16), "sum", group, wire)
        return _unflat(s.float(), grads)
    if mode == "int8":
        leaves = {k: reference_leaf(k) for k in grads}
        order = {r: i for i, r in enumerate(dict.fromkeys(leaves.values()))}
        peak = torch.stack([g.float().abs().max() for g in grads.values()])
        at = torch.tensor([order[leaves[k]] for k in grads], device=peak.device)
        scale = torch.zeros(len(order), device=peak.device).scatter_reduce(
            0, at, peak, "amax")
        scale = _all_reduce(torch.clamp_min(scale, 1e-12) / 127.0, "max", group, wire)[at]
        q = [torch.clamp(torch.round(g.float() / scale[i]), -127.0, 127.0).to(torch.int8)
             for i, g in enumerate(grads.values())]
        s = _unflat(_all_reduce(_flat(q, torch.int32), "sum", group, wire), grads)
        return {k: s[k].float() * scale[i] for i, k in enumerate(grads)}
    raise ValueError(f"unknown gradient compression {mode!r}")


def make_manual_dp_train_step(
    cfg: ModelConfig,
    mesh,
    opt_cfg: Optional[OptimizerConfig] = None,
    dp_axes: tuple = ("data",),
):
    """Returns ``step(params, opt_state, batch)`` over a multi-process
    ``mesh``: ``params`` (a :class:`~repro_torch.models.Model`, the same on
    every rank) and ``opt_state`` are updated in place, ``batch`` is the
    global batch (the same on every rank), of which the rank takes the
    contiguous slice at its index over ``dp_axes`` (row-major in mesh
    order).  The gradient reduction is an explicit, optionally compressed
    all-reduce over the group of ``dp_axes``; the loss and the gradients
    are divided by the dp size."""
    opt_cfg = opt_cfg or OptimizerConfig()
    mode = opt_cfg.grad_compression
    if not mesh.multi_process:
        raise ValueError("make_manual_dp_train_step takes a multi-process mesh "
                         "(torch.distributed with one rank per device); on one "
                         "process use train.make_train_step")
    group = mesh.group(dp_axes)
    n = 1
    for a in dp_axes:
        n *= mesh.shape[a]
    index = mesh.index(dp_axes)

    def local(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over {n} ranks")
        rows = x.shape[0] // n
        return x[index * rows:(index + 1) * rows]

    def step(params, opt_state, batch):
        wire = collections.Counter()
        loss, grads = loss_and_grads(cfg, params, {k: local(x) for k, x in batch.items()})
        grads = {k: g / n for k, g in _quantise_all_reduce(grads, group, mode, wire).items()}
        loss = _all_reduce(loss.float().reshape(1), "sum", group, wire)[0] / n
        stats = adamw_update_(params, grads, opt_state, opt_cfg)
        step.wire = dict(wire)
        return params, opt_state, {"loss": loss, **stats}

    step.wire = {}
    return step


__all__ = ["make_manual_dp_train_step"]
