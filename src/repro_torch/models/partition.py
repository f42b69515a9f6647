"""Parameter partitioning (the reference's ``models/partition.py``): logical
axes per parameter, derived from the parameter's name and rank (t5x-style
path rules) so the spec never drifts from the model's structure; and the
decode cache's layout (the reference's ``launch/cells._cache_logical_axes``,
one definition for the dry run's cells and the live decode).

Logical names used on params:
  "fsdp"      — dim sharded over the FSDP axes (pod, data) in training rules
  "model_dim" — dim sharded over the tensor-parallel "model" axis
  "vocab"     — vocabulary dim ("model" axis)
  "expert"    — MoE expert dim ("model" axis, expert parallelism)

The rules key on a parameter's last name (``layers.3.attn.wq`` -> ``wq``),
and an expert matrix under ``moe`` takes the MoE rules.  The reference
stacks a layer's parameters over the layers and pads a spec with ``None``
on the left for the stacked axes; the port keeps each layer's parameters
apart, so a parameter's spec is the reference's with those axes dropped.
"""
from __future__ import annotations

import torch
from torch import nn

# (key name) -> base logical axes (without any stacked-layer leading dims)
_RULES = {
    "embed": ("vocab", "fsdp"),
    "head": ("fsdp", "vocab"),
    "patch_proj": ("fsdp", "model_dim"),
    # attention
    "wq": ("fsdp", "model_dim"),
    "wk": ("fsdp", "model_dim"),
    "wv": ("fsdp", "model_dim"),
    "wo": ("model_dim", "fsdp"),
    "bq": ("model_dim",),
    "bk": ("model_dim",),
    "bv": ("model_dim",),
    # mlp
    "w_gate": ("fsdp", "model_dim"),
    "w_up": ("fsdp", "model_dim"),
    "w_down": ("model_dim", "fsdp"),
    "b_up": ("model_dim",),
    "b_down": (None,),
    # moe (rank-3 leaves resolved below)
    "router": (None, "expert"),
    # rwkv time mix
    "w_r": ("fsdp", "model_dim"),
    "w_k": ("fsdp", "model_dim"),
    "w_v": ("model_dim", "fsdp"),
    "w_g": ("fsdp", "model_dim"),
    "w_o": ("model_dim", "fsdp"),
    "decay_a": ("fsdp", None),
    "decay_b": (None, "fsdp"),
    "bonus_u": (None, None),
    # rglru
    "w_x": ("fsdp", "model_dim"),
    "w_y": ("fsdp", "model_dim"),
    "conv_w": (None, "model_dim"),
    "conv_b": ("model_dim",),
    "w_gate_a": ("fsdp", "model_dim"),
    "b_gate_a": ("model_dim",),
    "w_gate_x": ("fsdp", "model_dim"),
    "b_gate_x": ("model_dim",),
    "lambda": ("model_dim",),
}

# Expert weights: EP over "model" on the expert dim; the ff dim shards over
# the FSDP axes without per-layer gathers.
_MOE_RULES = {
    "w_gate": ("expert", None, "fsdp"),
    "w_up": ("expert", None, "fsdp"),
    "w_down": ("expert", "fsdp", None),
}


def _leaf_spec(name: str, ndim: int) -> tuple:
    keys = [k for k in name.split(".") if not k.isdigit()]  # list indices carry no key
    last = keys[-1] if keys else ""
    if "moe" in keys and last in _MOE_RULES:
        base = _MOE_RULES[last]
    elif last in _RULES:
        base = _RULES[last]
    else:
        base = (None,) * ndim  # norms, scalars, mus
    extra = ndim - len(base)
    if extra < 0:  # e.g. tied/unstacked variant; truncate from the left
        base = base[-ndim:] if ndim else ()
        extra = 0
    return (None,) * extra + tuple(base)


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_logical_axes(params) -> dict:
    """{name: logical-axis tuple} for a model (or a {name: tensor} dict)."""
    return {k: _leaf_spec(k, p.ndim) for k, p in _named(params).items()}


def param_shardings(params, mesh, rules) -> dict:
    """{name: ``launch.sharding.NamedSharding``} for a model (or a {name:
    tensor} dict) on ``mesh`` under ``rules``."""
    from ..launch.sharding import sharding_for

    named = _named(params)
    return {k: sharding_for(spec, tuple(named[k].shape), mesh, rules)
            for k, spec in param_logical_axes(named).items()}


def distribute(t: torch.Tensor, sharding) -> torch.Tensor:
    """The whole tensor ``t`` (the same on every rank) as a DTensor laid out
    by ``sharding`` (a ``launch.sharding.NamedSharding`` on a multi-process
    mesh): the rank keeps a copy of its own block, so nothing crosses the
    wire and the whole tensor can be freed."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import local_block

    mesh = sharding.mesh
    block = local_block(t, sharding).to(mesh.device).contiguous().clone()
    with torch.no_grad():
        return DTensor.from_local(block, mesh.device_mesh, sharding.placements,
                                  run_check=False, shape=t.shape, stride=t.stride())


def shard_params(model: nn.Module, mesh, rules) -> nn.Module:
    """Lay every parameter of ``model`` out by :func:`param_shardings` under
    ``rules``, in place: each becomes a DTensor of which the rank holds its
    block (``model`` must be whole and the same on every rank, e.g. drawn
    from one seed).  The sharded train step (``train.make_train_step``
    under ``sharding_context(mesh, rules)``) computes on it.  Returns
    ``model``."""
    shardings = param_shardings(model, mesh, rules)
    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner._parameters[leaf] = nn.Parameter(distribute(p.detach(), shardings[name]),
                                               requires_grad=False)
    return model


def shard_opt_state(state: dict, model: nn.Module, mesh, rules) -> dict:
    """The optimizer state ``{"m", "v", "step"}`` (whole, f32) laid out as
    ``model``'s parameters under ``rules``: each moment a DTensor placed
    as its parameter; the step stays a plain tensor."""
    shardings = param_shardings(model, mesh, rules)
    return {key: {k: distribute(t, shardings[k]) for k, t in state[key].items()}
            for key in ("m", "v")} | {"step": state["step"]}


# ----------------------------------------------------------------------------
# the decode cache
# ----------------------------------------------------------------------------

# (a cache leaf's last key) -> its logical axes, without stacked layer axes
_CACHE_AXES = {
    "k": ("batch", "seq", "kv_heads", "head_dim"),
    "v": ("batch", "seq", "kv_heads", "head_dim"),
    "xk": ("batch", "frames", "kv_heads", "head_dim"),
    "xv": ("batch", "frames", "kv_heads", "head_dim"),
    "s": ("batch", "heads", None, None),
    "last_time": ("batch", "embed"),
    "last_chan": ("batch", "embed"),
    "h": ("batch", "rnn"),
    "conv": ("batch", None, "rnn"),
    "window": (),
}


def _cache_leaf_axes(name: str, ndim: int) -> tuple:
    if name.startswith("l") and name.endswith("_k"):
        name = "k"
    if name.startswith("l") and name.endswith("_v"):
        name = "v"
    base = _CACHE_AXES.get(name, (None,) * ndim)
    extra = ndim - len(base)
    if extra < 0:
        base = base[-ndim:] if ndim else ()
        extra = 0
    return (None,) * extra + tuple(base)


def _map_cache(fn, tree, name=""):
    """``fn(last key, leaf)`` over a cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _map_cache(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_cache(fn, v, name) for v in tree]
    return fn(name, tree)


def cache_logical_axes(cache) -> dict:
    """The reference's logical axes of each cache leaf (its
    ``launch/cells._cache_logical_axes``), by the leaf's last key
    (``l{i}_k`` / ``l{i}_v`` as ``k`` / ``v``), left-padded with ``None``
    for stacked layer axes."""
    return _map_cache(lambda name, leaf: _cache_leaf_axes(name, getattr(leaf, "ndim", 0)),
                      cache)


def cache_shardings(cache, mesh, rules) -> dict:
    """The cache tree of ``launch.sharding.NamedSharding``s on ``mesh``
    under ``rules``: ``spec_for`` of each leaf's logical axes, so under
    ``DECODE_RULES`` the slots (``seq``, ``frames``) split over "model"
    and the kv heads stay whole (a mesh axis is used once); a dim that
    does not divide stays whole."""
    from ..launch.sharding import sharding_for

    return _map_cache(lambda name, leaf: sharding_for(_cache_leaf_axes(name, leaf.ndim),
                                                      tuple(leaf.shape), mesh, rules), cache)


def shard_cache(cache, mesh, rules) -> dict:
    """The whole cache ``cache`` (the same on every rank) laid out by
    :func:`cache_shardings`: each leaf a DTensor of which the rank keeps
    its block (:func:`distribute`), as :func:`shard_params` places the
    parameters.  ``models.decode_step`` writes the blocks in place;
    ``train.sharded.whole_tree`` gathers them back."""
    return _zip_cache(distribute, cache, cache_shardings(cache, mesh, rules))


def zeros_cache(cache, mesh, rules) -> dict:
    """A zero cache of ``cache``'s shapes and types (meta tensors serve)
    laid out as :func:`shard_cache` lays it out: each rank allocates only
    its blocks, on the mesh's device."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import local_block

    def place(t, sh):
        block = torch.zeros(local_block(t, sh).shape, dtype=t.dtype, device=sh.mesh.device)
        return DTensor.from_local(block, sh.mesh.device_mesh, sh.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return _zip_cache(place, cache, cache_shardings(cache, mesh, rules))


def _zip_cache(fn, cache, shardings):
    if isinstance(cache, dict):
        return {k: _zip_cache(fn, v, shardings[k]) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_zip_cache(fn, v, s) for v, s in zip(cache, shardings)]
    return fn(cache, shardings)


__all__ = ["param_logical_axes", "param_shardings", "distribute", "shard_params",
           "shard_opt_state", "cache_logical_axes", "cache_shardings", "shard_cache",
           "zeros_cache"]
