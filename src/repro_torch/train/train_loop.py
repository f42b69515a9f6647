"""Train-step factory (the reference's ``train/train_loop.py``): the loss
and its gradients over microbatches, gradient compression, and the AdamW
update.

``train_step(params, opt_state, batch)`` takes a :class:`~repro_torch.models.Model`
and updates its parameters and the optimizer state in place (it returns
the same module and state; ``optimizer.adamw_update_``), so a step holds
one copy of the weights and of the moments.  With microbatches each one's
gradients come from ``torch.autograd.grad`` and are summed into f32
buffers, as the reference's ``jax.lax.scan`` sums them (``.grad``
accumulation would sum in the parameters' bf16).

**The sharded step.**  On a model laid out by
``models.partition.shard_params`` (DTensor parameters and moments), called
under ``sharding_context(mesh, rules)`` on a multi-process mesh, the step
is the reference's ``make_train_step`` lowered under that context: every
rank takes the same global ``batch``; microbatch ``i`` is its rows ``[i *
B / n, (i + 1) * B / n)``, of which the rank computes its block over the
batch axes; the layers gather their FSDP shards and split heads, channels,
experts and the vocabulary over "model" (``train.sharded``); each
microbatch's reduce-scattered shard gradients are summed in f32; the
gradients of parameters not split over the batch axes are all-reduced
over them once; and AdamW updates each rank's shards in place.  The step
has ``.accumulate(params, batch, micro)`` (the microbatches ``micro``'s
loss sum and f32 gradient sums) and ``.apply(params, opt_state, loss_sum,
grads)`` (the reductions and the update), which the dry run traces apart.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..launch import sharding as S
from ..models import loss_fn
from ..models.config import ModelConfig
from . import sharded as SH
from .optimizer import (
    OptimizerConfig,
    adamw_update_,
    compress_grads,
    compress_sharded,
    sharded_global_norm,
)


def _split_microbatches(batch: dict, n: int) -> list:
    def split(x, i):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x[i * (b // n):(i + 1) * (b // n)]

    return [{k: split(x, i) for k, x in batch.items()} for i in range(n)]


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss f32 scalar, {name: gradient in the parameter's type}) of
    ``loss_fn`` at ``params``; the parameters' ``.grad`` stay untouched."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: Optional[OptimizerConfig] = None,
    num_microbatches: int = 1,
):
    opt_cfg = opt_cfg or OptimizerConfig()
    sharded = _sharded_step(cfg, opt_cfg, num_microbatches)

    def train_step(params, opt_state, batch):
        if SH.sharded(params):
            return sharded(params, opt_state, batch)
        if num_microbatches > 1:
            loss_sum, acc = None, None
            for mb in _split_microbatches(batch, num_microbatches):
                loss, grads = loss_and_grads(cfg, params, mb)
                if acc is None:
                    loss_sum = loss.float()
                    acc = {k: g.float() for k, g in grads.items()}
                else:
                    loss_sum = loss_sum + loss
                    for k, g in grads.items():
                        acc[k] += g.float()
                del grads
            loss = loss_sum / num_microbatches
            grads = {k: g / num_microbatches for k, g in acc.items()}
        else:
            loss, grads = loss_and_grads(cfg, params, batch)
        grads = compress_grads(grads, opt_cfg.grad_compression)
        stats = adamw_update_(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **stats}

    train_step.accumulate, train_step.apply = sharded.accumulate, sharded.apply
    return train_step


def _rows(x, i: int, n: int, index: int, shards: int):
    """Microbatch ``i`` of ``n`` of a global batch leaf, and of it the block
    ``index`` of ``shards``."""
    x = torch.as_tensor(x)
    b = x.shape[0]
    if b % (n * shards):
        raise ValueError(f"batch {b} does not split into {n} microbatches over {shards} "
                         "batch shards")
    rows = b // n
    block = rows // shards
    return x[i * rows + index * block:i * rows + (index + 1) * block]


def _batch_axes():
    mesh = S._CTX.mesh
    if mesh is None or not mesh.multi_process:
        raise RuntimeError("a sharded model trains under sharding_context(mesh, rules) on "
                           "a multi-process mesh")
    return mesh, S.mesh_batch_axes(mesh, S._CTX.rules)


def _sharded_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, n: int):
    def accumulate(params, batch, micro=None):
        mesh, axes = _batch_axes()
        shards = math.prod(mesh.shape[a] for a in axes)
        index = mesh.index(axes) if axes else 0
        leaves = {k: SH.local(p) for k, p in params.named_parameters()}
        for t in leaves.values():
            t.requires_grad_(True)
        loss_sum, acc = None, None
        for i in range(n) if micro is None else micro:
            mb = {k: _rows(x, i, n, index, shards) for k, x in batch.items()}
            with torch.enable_grad():
                loss = loss_fn(cfg, params, mb)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            if acc is None:
                loss_sum, acc = loss.detach().float(), [g.float() for g in grads]
            else:
                loss_sum = loss_sum + loss.detach()
                for a, g in zip(acc, grads):
                    a += g
            del grads
        return loss_sum, dict(zip(leaves, acc))

    def apply(params, opt_state, loss_sum, grads):
        mesh, axes = _batch_axes()
        named = dict(params.named_parameters())
        # the rest of each gradient's sum over the batch axes: one flat f32
        # all-reduce over the axes that do not split the parameter
        pending: dict = {}
        for k, p in named.items():
            split = {a for a, pl in zip(p.device_mesh.mesh_dim_names, p.placements)
                     if pl.is_shard()}
            rest = tuple(a for a in axes if a not in split)
            if rest and math.prod(mesh.shape[a] for a in rest) > 1:
                pending.setdefault(rest, []).append(k)
        for rest, keys in pending.items():
            flat = SH.all_reduce(torch.cat([grads[k].reshape(-1) for k in keys]),
                                 mesh.group(rest))
            at = 0
            for k in keys:
                grads[k] = flat[at:at + grads[k].numel()].view(grads[k].shape)
                at += grads[k].numel()
        if axes and math.prod(mesh.shape[a] for a in axes) > 1:
            loss_sum = SH.all_reduce(loss_sum, mesh.group(axes))
        loss = loss_sum / n
        grads = compress_sharded({k: g / n for k, g in grads.items()},
                                 opt_cfg.grad_compression)
        leaves = {k: SH.local(p) for k, p in named.items()}
        state = {"m": {k: SH.local(t) for k, t in opt_state["m"].items()},
                 "v": {k: SH.local(t) for k, t in opt_state["v"].items()},
                 "step": SH.local(opt_state["step"])}
        norm = sharded_global_norm(grads, named)
        stats = adamw_update_(leaves, grads, state, opt_cfg, norm=norm)
        opt_state["step"] = state["step"]
        return params, opt_state, {"loss": loss, **stats}

    def step(params, opt_state, batch):
        return apply(params, opt_state, *accumulate(params, batch))

    step.accumulate, step.apply = accumulate, apply
    return step


__all__ = ["make_train_step", "loss_and_grads"]
