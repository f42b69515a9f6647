"""Logical-axis sharding rules (MaxText/t5x style) with divisibility fallback
(the reference's ``launch/sharding.py``).

Model code names the axes of parameters and activations with *logical*
names ("batch", "embed", "heads", "mlp", "vocab", "expert", ...).  A rule
table maps logical names to mesh axes.  A logical dim is sharded on its
mesh axis only if the dim size is divisible by the axis size — otherwise it
falls back to the next rule or replication (e.g. qwen2's 12 heads stay
replicated on a 16-way "model" axis while its d_ff=8960 shards).

A spec is a plain tuple with one entry per dim: ``None``, a mesh axis, or a
tuple of mesh axes (the reference's ``PartitionSpec``).  On a multi-process
mesh :func:`sharding_for` turns it into DTensor placements; on a
one-process mesh :func:`data_parallel` runs one batch slice per device.

:func:`shard_activation` returns its input: in the reference it is a layout
hint (``with_sharding_constraint``) that tells XLA's partitioner where an
intermediate lives, and it changes no value.  The port's sharded step
(``train.sharded``) moves its activations between layouts by hand, where
the compute layout below asks for it.  What does change values under a
sharding context is :func:`num_batch_shards`, which the MoE dispatch reads
to keep its capacity per batch shard.

**Storage and compute layouts.**  A parameter is stored as its spec says
(:func:`local_block` is a rank's block of it; ``train.sharded`` gathers
its split dims over the mesh's groups of the axes that split them).  It is computed on as
:func:`compute_split` says: a weight whose spec splits a dim over "model"
is used split only where its block can split its heads (or channels,
experts) over that axis; qwen2's 12 heads on a 16-way axis split ``wq``'s
columns in storage (12 x 128 divides 16) but not in compute, so its model
shards are gathered first and every head computed on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .mesh import Mesh

# logical axis -> mesh axis (or tuple of mesh axes, or list of candidate
# mesh-axis assignments tried in order).
Rules = dict

# Default training rules: FSDP over (pod, data), tensor parallel over model.
TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,  # attention K/V stay seq-replicated even under SP
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "capacity": None,
    "data_group": ("pod", "data"),  # MoE dispatch group = one per batch shard
    "layers": None,
    "fsdp": ("pod", "data"),   # weight-shard axis for FSDP
    "rnn": "model",
    "conv": None,
    "frames": None,
    # parameter logical axes (see repro_torch.models.partition)
    "model_dim": "model",
}

# Serving rules: batch over data; weights 2D-sharded (model x data) so even
# the 235B MoE fits per-device memory without FSDP gathers of full layers.
SERVE_RULES: Rules = {
    **TRAIN_RULES,
    "batch": ("pod", "data"),
    "fsdp": "data",
}

# Decode adds KV-cache sequence sharding over the model axis (decode
# activations have seq=1, which falls back to replicated automatically).
DECODE_RULES: Rules = {
    **SERVE_RULES,
    "seq": "model",
    "frames": "model",
}

# Sequence parallelism: residual-stream activations sharded over the model
# axis between blocks.
TRAIN_RULES_SP: Rules = {**TRAIN_RULES, "seq": "model"}

# Decode without 2D weight sharding (small models: no per-layer weight
# collectives; weights must fit per device on the model axis alone).
DECODE_RULES_1D: Rules = {**DECODE_RULES, "fsdp": None}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_context(mesh: Mesh, rules: Rules):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def in_same_context(fn):
    """``fn`` wrapped to run in the sharding context active now, wherever
    and whenever it is called (``fn`` itself when none is active): a remat
    recomputation runs on the autograd engine's device thread, where the
    caller's context is not active."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return fn

    def run(*args, **kw):
        with sharding_context(mesh, rules):
            return fn(*args, **kw)

    return run


def active() -> bool:
    return _CTX.mesh is not None


def num_batch_shards() -> int:
    """How many ways the batch is sharded under the active rules (1 outside a
    sharding context).  Model code uses this to keep data-local operations
    (e.g. MoE dispatch sort) from acquiring global semantics."""
    if not active():
        return 1
    target = _CTX.rules.get("batch")
    if target is None:
        return 1
    return _axis_size(_CTX.mesh, _mesh_axes_for(_CTX.mesh, target))


def _axis_size(mesh: Mesh, axis: Union[str, tuple, None]) -> int:
    if axis is None:
        return 1
    out = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        out *= mesh.shape[a]
    return out


def _mesh_axes_for(mesh: Mesh, axis) -> tuple:
    """Filter a rule target down to axes present in the mesh."""
    if axis is None:
        return ()
    axes = axis if isinstance(axis, tuple) else (axis,)
    return tuple(a for a in axes if a in mesh.shape)


def spec_for(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: Optional[Rules] = None,
    mesh: Optional[Mesh] = None,
) -> tuple:
    """The spec for a value with given logical axes and shape, applying the
    divisibility fallback per dimension and never reusing a mesh axis."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        raise ValueError("spec_for needs a mesh and rules, or a sharding context")
    used: set = set()
    parts = []
    for name, dim in zip(logical, shape):
        assigned = None
        if name is not None and name in rules:
            target = rules[name]
            for cand in target if isinstance(target, list) else [target]:
                axes = tuple(a for a in _mesh_axes_for(mesh, cand) if a not in used)
                if not axes:
                    continue
                size = _axis_size(mesh, axes)
                if size > 1 and dim % size == 0:
                    assigned = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
                    break
        parts.append(assigned)
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``) and its DTensor
    placements: ``Shard(d)`` on each mesh axis that tensor dim ``d`` is split
    over, ``Replicate()`` on the others."""
    mesh: Mesh
    spec: tuple
    placements: tuple


def placements_for(spec: tuple, mesh: Mesh) -> tuple:
    """DTensor placements, one per mesh axis, for ``spec``.  A dim split
    over several axes is split over them in mesh order (major first), as
    a tuple entry of a ``PartitionSpec`` lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in mesh.axis_names}
    for dim, entry in enumerate(spec):
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"dim {dim} is split over {axes}, not in the mesh's order "
                             f"{mesh.axis_names}: DTensor lays such a split out otherwise")
        for a in axes:
            out[a] = Shard(dim)
    return tuple(out[a] for a in mesh.axis_names)


def sharding_for(logical, shape, mesh=None, rules=None) -> NamedSharding:
    mesh = mesh or _CTX.mesh
    spec = spec_for(logical, shape, rules, mesh)
    return NamedSharding(mesh, spec, placements_for(spec, mesh))


def _axes_of(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def local_block(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` laid out by ``sharding``
    on a multi-process mesh: each dim cut along the mesh axes its spec
    names, major first (DTensor's layout of the placements).  A view."""
    mesh = sharding.mesh
    coord = mesh.coordinate()
    for dim, entry in enumerate(sharding.spec):
        for a in _axes_of(entry):
            size = t.shape[dim] // mesh.shape[a]
            t = t.narrow(dim, coord[a] * size, size)
    return t


def compute_split(spec: tuple, heads: Optional[int], mesh: Mesh) -> bool:
    """Whether a weight of ``spec`` is computed on split over "model": its
    spec splits a dim over it and ``heads`` (the block's head, channel or
    expert count along that dim; None where the dim is no head dim) divide
    the axis."""
    n = mesh.shape.get("model", 1)
    split = any("model" in _axes_of(e) for e in spec)
    return n > 1 and split and (heads is None or heads % n == 0)


def shard_activation(x, logical: Sequence[Optional[str]]):
    """``x`` unchanged: a layout hint with no numeric effect (module
    docstring)."""
    return x


def mesh_batch_axes(mesh: Mesh, rules: Optional[Rules] = None) -> tuple:
    """Mesh axes the batch dimension maps to under ``rules`` (no context
    needed — used by the serving layer to size device-sharded score batches)."""
    rules = rules or SERVE_RULES
    return _mesh_axes_for(mesh, rules.get("batch"))


def mesh_batch_shards(mesh: Mesh, rules: Optional[Rules] = None) -> int:
    """How many ways a batch dimension is sharded on ``mesh`` under ``rules``."""
    return _axis_size(mesh, mesh_batch_axes(mesh, rules))


def _slice_devices(mesh: Mesh, axes: tuple) -> list:
    """The device of each batch slice: along ``axes`` in row-major order,
    index 0 on the mesh's other axes."""
    grid = np.empty(len(mesh.devices), dtype=object)
    grid[:] = mesh.devices
    grid = grid.reshape(tuple(mesh.shape.values()))
    at = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    return list(grid[at].reshape(-1))


def data_parallel(fn, mesh: Mesh, rules: Optional[Rules] = None):
    """Wrap ``fn(params, batch)`` for a one-process ``mesh``: the parameters
    are replicated once onto each device that takes a slice, the leading
    (batch) dimension of every ``batch`` leaf is split in equal contiguous
    slices in device order, ``fn`` runs on each slice and the outputs are
    concatenated in order on the first device.  Callers pad the batch to a
    multiple of :func:`mesh_batch_shards`.  Identity when the rules give the
    mesh no batch axis (e.g. a model-only mesh)."""
    if mesh.multi_process:
        raise ValueError("data_parallel splits a batch over a one-process mesh; on a "
                         "multi-process mesh each rank runs its own slice "
                         "(train.manual_dp)")
    axes = mesh_batch_axes(mesh, rules)
    if not axes:
        return fn
    devices = _slice_devices(mesh, axes)
    replicas: dict = {}

    def on(params, dev):
        key = (id(params), dev)
        if key not in replicas or replicas[key][0] is not params:
            at = next(params.parameters()).device if isinstance(params, torch.nn.Module) \
                else None
            same = at is not None and at.type == dev.type and (
                dev.type == "cpu" or at.index == dev.index)
            replicas[key] = (params, params if same else _to(params, dev))
        return replicas[key][1]

    def run(params, batch):
        n = len(devices)
        parts = []
        for i, dev in enumerate(devices):
            sl = {}
            for k, x in batch.items():
                x = torch.as_tensor(x)
                if x.shape[0] % n:
                    raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does not "
                                     f"split into {n} slices")
                rows = x.shape[0] // n
                sl[k] = x[i * rows:(i + 1) * rows].to(dev)
            parts.append(fn(on(params, dev), sl))
        if n == 1:  # one slice: its output, without a copy
            return parts[0]
        return torch.cat([p.to(devices[0]) for p in parts])

    return run


def _to(params, dev):
    import copy

    if isinstance(params, torch.nn.Module):
        return copy.deepcopy(params).to(dev)
    return {k: v.to(dev) for k, v in params.items()}


def tree_shardings(specs_tree, shapes_tree, mesh=None, rules=None):
    """Map a tree (nested dicts and lists) of logical-axis tuples and the
    matching tree of shapes to :class:`NamedSharding`s."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if isinstance(specs_tree, dict):
        return {k: tree_shardings(v, shapes_tree[k], mesh, rules) for k, v in specs_tree.items()}
    if isinstance(specs_tree, list):
        return [tree_shardings(v, s, mesh, rules) for v, s in zip(specs_tree, shapes_tree)]
    return sharding_for(specs_tree, tuple(shapes_tree), mesh, rules)


__all__ = [
    "TRAIN_RULES", "SERVE_RULES", "DECODE_RULES", "TRAIN_RULES_SP", "DECODE_RULES_1D",
    "NamedSharding", "sharding_context", "in_same_context", "active", "num_batch_shards", "spec_for",
    "placements_for", "sharding_for", "shard_activation", "mesh_batch_axes",
    "mesh_batch_shards", "data_parallel", "tree_shardings", "local_block",
    "compute_split",
]
