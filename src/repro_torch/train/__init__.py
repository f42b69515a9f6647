"""Training: AdamW with its schedule and clipping, gradient compression,
and the microbatched train step (the reference's ``repro.train``), on one
card or, on a sharded model under ``sharding_context``, over a mesh
(``train.sharded``)."""
from .optimizer import (  # noqa: F401
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from .train_loop import loss_and_grads, make_train_step  # noqa: F401
