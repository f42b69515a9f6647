"""Dry-run cell definitions (the reference's ``launch/cells.py``):
(architecture x input shape) -> the step one rank of the port runs on the
production mesh, its inputs as meta tensors with their shardings, and the
loop counts that the trace unrolls.

Shapes: train_4k (a data-parallel train step), prefill_32k (forward),
decode_32k / long_500k (one decode token against a KV cache or state).
``long_500k`` requires sub-quadratic sequence mixing and is skipped for pure
full-attention architectures.

**A cell is the program one rank of the port runs on that mesh.**

* train is the reference's: ``train.make_train_step`` with the default
  :class:`OptimizerConfig` and ``DEFAULT_MICROBATCHES`` (8) microbatches,
  run under ``sharding_context(mesh, TRAIN_RULES)`` on parameters and
  moments sharded by ``models.partition.shard_params`` (meta DTensors: the
  rank holds its blocks, ``param_bytes_sharded``).  The step takes the
  global batch and computes its block of each microbatch; the layers
  gather their FSDP shards and split heads, channels, experts and the
  vocabulary over "model" (``train.sharded``).  :func:`trace_cell` traces
  one microbatch and counts it ``num_microbatches`` times, as the
  reference's analyzer expands its ``accum_scan``, then the reductions
  and the optimizer once;
* prefill is ``models.forward`` under ``SERVE_RULES`` and decode
  ``models.decode_step`` under ``DECODE_RULES``, as the reference lowers
  them: the parameters sharded by ``shard_params`` under those rules (2-D,
  "fsdp" over "data" alone, each layer gathering its "data" shards), and
  decode's cache made by ``init_cache(..., mesh=, rules=)`` at the cell's
  global batch (``models.partition.shard_cache``'s layout: its slots over
  "model", its batch over the batch axes, each rank holding its blocks).
  Their inputs are the rank's rows: the batch dim split as
  ``sharding.spec_for`` splits it, and whole where the rules give no
  divisible axis (long_500k's batch of 1).  The MoE dispatch routes the
  rank's rows as one group, the reference's group of that batch shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..configs import ARCHS, get_config
from ..models import decode_step, forward, init_cache, init_params
from ..models.config import ModelConfig
from ..models.partition import cache_logical_axes, param_shardings, shard_params
from ..train import OptimizerConfig, init_opt_state, make_train_step
from ..train.sharded import local as local_shard
from .sharding import (
    DECODE_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    sharding_context,
    sharding_for,
)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

DEFAULT_MICROBATCHES = 8


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "needs sub-quadratic attention (pure full-attention arch)"
    return True, ""


def all_cells():
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            out.append((arch, shape))
    return out


# ----------------------------------------------------------------------------
# logical axes for batch inputs and caches
# ----------------------------------------------------------------------------

_cache_logical_axes = cache_logical_axes  # the reference's name


def _meta(shape, dtype, logical, mesh, rules) -> torch.Tensor:
    """A meta tensor of the global ``shape`` carrying its ``NamedSharding``
    (``.sharding``), the port's ``ShapeDtypeStruct``."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    x.sharding = sharding_for(logical, shape, mesh, rules)
    return x


def local_shape(shape, sharding) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``sharding`` (each dim over the mesh axes its spec names)."""
    out = list(shape)
    for dim, entry in enumerate(sharding.spec):
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            out[dim] //= sharding.mesh.shape[a]
    return tuple(out)


def local(x: torch.Tensor) -> torch.Tensor:
    """The meta block one rank holds of a meta input from
    :func:`input_specs`."""
    return torch.empty(local_shape(x.shape, x.sharding), dtype=x.dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str, mesh, rules) -> dict:
    """Meta stand-ins for every model input of this cell, at the global
    shape, each with its ``NamedSharding`` as ``.sharding``: nothing is
    allocated."""
    sh = SHAPES[shape_name]
    b, s = sh["batch"], sh["seq"]
    batch: dict = {}
    if sh["kind"] in ("train", "prefill"):
        s_text = s - (cfg.num_patches if cfg.num_patches else 0)
        batch["tokens"] = _meta((b, s_text), torch.int32, ("batch", None), mesh, rules)
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16,
                                    ("batch", None, None), mesh, rules)
        if cfg.num_patches:
            batch["patches"] = _meta((b, cfg.num_patches, cfg.d_model), torch.bfloat16,
                                     ("batch", None, None), mesh, rules)
    else:
        batch["tokens"] = _meta((b, 1), torch.int32, ("batch", None), mesh, rules)
    return batch


@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: str
    cfg: ModelConfig
    fn: object              # the rank's step
    args: tuple             # meta tensors (parameters, state, inputs)
    trip_hints: dict
    rules: dict
    num_microbatches: int = 1
    trace: object = None    # the ``roofline.CostMode`` of the last trace_cell

    @property
    def kind(self):
        return SHAPES[self.shape_name]["kind"]


def _trip_hints(cfg: ModelConfig, shape_name: str, num_micro: int) -> dict:
    """The reference's while-loop trip counts of this cell: the loops that
    the port's trace runs out (layers, microbatches, attention's query
    chunks, the scans' time steps)."""
    sh = SHAPES[shape_name]
    s = sh["seq"]
    kind = sh["kind"]
    hints: dict = {"accum_scan": num_micro}
    if cfg.family == "hybrid":
        hints["layers_scan"] = cfg.num_layers // len(cfg.pattern)
    elif cfg.family == "encdec":
        hints["layers_scan"] = cfg.num_layers
        hints["encoder_scan"] = cfg.encoder_layers
    else:
        hints["layers_scan"] = cfg.num_layers
    if kind in ("train", "prefill"):
        qc = cfg.attn_q_chunk
        hints["attn_q_scan"] = max(math.ceil(s / qc), 1)
        if cfg.family == "encdec":
            hints["enc&attn_q_scan"] = max(math.ceil(cfg.encoder_seq / qc), 1)
        hints["rwkv_time_scan"] = s
        hints["rglru_time_scan"] = s
    else:
        hints["attn_q_scan"] = 1
        hints["rwkv_time_scan"] = 1
        hints["rglru_time_scan"] = 1
    return hints


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    rules_override: Optional[dict] = None,
    num_microbatches: Optional[int] = None,
    cfg_overrides: Optional[dict] = None,
) -> Cell:
    """The cell's rank program on ``mesh`` (a multi-process mesh; a world of
    one rank serves for a 1-device mesh): meta parameters, state and
    inputs, and the step.  Train takes ``num_microbatches`` (default
    ``DEFAULT_MICROBATCHES``); prefill and decode one."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} unsupported: {why}")
    sh = SHAPES[shape_name]
    kind = sh["kind"]

    if kind == "train":
        rules = rules_override or TRAIN_RULES
    elif kind == "prefill":
        rules = rules_override or SERVE_RULES
    else:
        rules = rules_override or DECODE_RULES
    n_micro = num_microbatches or (DEFAULT_MICROBATCHES if kind == "train" else 1)

    params = shard_params(init_params(cfg, device="meta"), mesh, rules)
    batch = input_specs(cfg, shape_name, mesh, rules)
    if kind == "train":
        step = make_train_step(cfg, OptimizerConfig(), n_micro)
        fn = _in_context(step, mesh, rules)
        fn.accumulate, fn.apply = (_in_context(f, mesh, rules)
                                   for f in (step.accumulate, step.apply))
        args = (params, init_opt_state(params), batch)
    elif kind == "prefill":
        fn = _in_context(lambda p, b: forward(cfg, p, b), mesh, rules)
        args = (params, {k: local(x) for k, x in batch.items()})
    else:
        cache = init_cache(cfg, sh["batch"], sh["seq"], mesh=mesh, rules=rules)
        fn = _in_context(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos), mesh, rules)
        pos = torch.empty((), dtype=torch.int32, device="meta")
        args = (params, cache, local(batch["tokens"]), pos)

    return Cell(
        arch=arch, shape_name=shape_name, cfg=cfg, fn=fn, args=args,
        trip_hints=_trip_hints(cfg, shape_name, n_micro), rules=rules,
        num_microbatches=n_micro,
    )


def _in_context(fn, mesh, rules):
    """``fn`` run under ``sharding_context(mesh, rules)``."""
    def inner(*args, **kw):
        with sharding_context(mesh, rules):
            return fn(*args, **kw)
    return inner


def tree_bytes(x) -> int:
    """Bytes a rank holds of the tensors of a tree (a module's parameters,
    dicts, lists, tuples): a DTensor's local shard."""
    if isinstance(x, torch.nn.Module):
        return tree_bytes(list(x.parameters()))
    if isinstance(x, dict):
        return sum(tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(tree_bytes(v) for v in x)
    if isinstance(x, torch.Tensor):
        t = local_shard(x)
        return t.numel() * t.element_size()
    return 0


def whole_bytes(model: torch.nn.Module) -> int:
    """Bytes of a model's parameters, whole."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def argument_bytes(cell: Cell) -> int:
    """Bytes a rank holds at rest for the step: its arguments (parameters,
    optimizer state or cache, and the inputs: the train step takes the
    global batch on every rank and slices its block)."""
    return tree_bytes(cell.args)


def param_bytes_sharded(cell: Cell, mesh) -> int:
    """Bytes a rank would hold of the parameters in the reference's layout
    (``models.partition.param_shardings`` under the cell's rules)."""
    params = cell.args[0]
    named = dict(params.named_parameters())
    out = 0
    for k, sh in param_shardings(params, mesh, cell.rules).items():
        p = named[k]
        out += math.prod(local_shape(tuple(p.shape), sh)) * p.element_size()
    return out


def trace_cell(cell: Cell, mesh) -> tuple:
    """Run the cell's step once on its meta arguments under
    ``roofline.CostMode``.  Returns (its :class:`~repro_torch.roofline.Cost`,
    memory {argument_bytes, output_bytes, temp_bytes, total_bytes}) and
    keeps the mode (its ``kernels``, ``links``, ``op_links``, ``ops`` and
    ``flop_counter_flops``, ``torch.utils.flop_counter``'s total over the
    same ops) as ``cell.trace``.  ``temp_bytes`` is the peak of the bytes
    the step allocates and holds at once (the mode's weak-reference counter
    over new storages).

    A train cell is traced in two parts: one microbatch, counted
    ``num_microbatches`` times, then the reductions and the optimizer once.
    Its ``temp_bytes`` is the f32 gradient sums (alive from the first
    microbatch to the update) plus the larger of the two parts' peaks."""
    at_rest = argument_bytes(cell)
    if cell.kind == "train":
        params, opt_state, batch = cell.args
        part, flops = _traced(lambda: cell.fn.accumulate(params, batch, range(1)))
        loss_sum, grads = part.result
        mode, flops2 = _traced(lambda: cell.fn.apply(params, opt_state, loss_sum, grads))
        mode.absorb(part, cell.num_microbatches)
        mode.flop_counter_flops = flops * cell.num_microbatches + flops2
        held = tree_bytes(grads)
        mode.peak_bytes = held + max(part.peak_bytes, mode.peak_bytes)
        produced = tree_bytes(mode.result[2])
    else:
        mode, mode.flop_counter_flops = _traced(lambda: cell.fn(*cell.args))
        produced = tree_bytes(mode.result[0] if cell.kind == "decode" else mode.result)
    memory = dict(argument_bytes=at_rest, output_bytes=produced,
                  temp_bytes=mode.peak_bytes, total_bytes=at_rest + mode.peak_bytes)
    del mode.result
    cell.trace = mode
    return mode.cost, memory


def _traced(fn):
    """(the ``CostMode`` of ``fn()``, with its value as ``.result``, and
    ``torch.utils.flop_counter``'s total over the same ops)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..roofline.trace_analysis import CostMode

    # the flop counter under the cost mode: the cost mode sees the ops as
    # the step dispatches them, before the counter decomposes any, and
    # passes every op with FLOPs on to it
    with FlopCounterMode(display=False) as counter, CostMode() as mode:
        mode.result = fn()
    return mode, float(counter.get_total_flops())


__all__ = ["SHAPES", "DEFAULT_MICROBATCHES", "Cell", "cell_supported", "all_cells",
           "input_specs", "build_cell", "trace_cell", "local", "local_shape", "tree_bytes",
           "whole_bytes", "argument_bytes", "param_bytes_sharded"]
