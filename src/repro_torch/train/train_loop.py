"""Train-step factory (the reference's ``train/train_loop.py``): the loss
and its gradients over microbatches, gradient compression, and the AdamW
update.

``train_step(params, opt_state, batch)`` takes a :class:`~repro_torch.models.Model`
and updates its parameters in place (it returns the same module), so a
step holds one copy of the weights.  With microbatches each one's
gradients come from ``torch.autograd.grad`` and are summed into f32
buffers, as the reference's ``jax.lax.scan`` sums them (``.grad``
accumulation would sum in the parameters' bf16).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import loss_fn
from ..models.config import ModelConfig
from .optimizer import OptimizerConfig, adamw_update, compress_grads


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

    def train_step(params, opt_state, batch):
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
        new_p, opt_state, stats = adamw_update(params, grads, opt_state, opt_cfg)
        del grads
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(new_p[name])
        return params, opt_state, {"loss": loss, **stats}

    return train_step


__all__ = ["make_train_step", "loss_and_grads"]
