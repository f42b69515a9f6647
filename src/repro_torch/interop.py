"""Carrying state across from the reference package.

These helpers take what the reference hands out as plain data —
``dataclasses.asdict(BASConfig())``, numpy embeddings, a model's parameter
tree or its optimizer state as numpy arrays — and build the port's objects, so a test can feed both
packages the same thing.  They import neither package: the caller converts
(``jax.tree.map(np.asarray, params)``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import BASConfig, JoinSpec
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import STACKED, Model



def bas_config_from_dict(d: dict) -> BASConfig:
    """A :class:`BASConfig` from the reference's ``asdict`` output.  Unknown
    keys raise, so a field added on one side cannot be dropped silently."""
    names = {f.name for f in dataclasses.fields(BASConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown BASConfig fields: {sorted(unknown)}")
    return BASConfig(**d)


def spec_from_arrays(embeddings: list) -> JoinSpec:
    """A :class:`JoinSpec` over float32 copies of numpy embeddings."""
    return JoinSpec(embeddings=[np.asarray(e, np.float32) for e in embeddings])


def _flatten(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict / list tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _to_torch(arr) -> torch.Tensor:
    """A numpy array as a tensor.  JAX's bfloat16 arrays come out of
    ``np.asarray`` with the ``ml_dtypes`` bfloat16 type, which
    ``torch.from_numpy`` rejects: their bits are taken as uint16 and viewed
    as ``torch.bfloat16``."""
    a = np.array(arr)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _named_leaves(tree: dict, model: Model) -> dict:
    """The reference tree's leaves as tensors under the port's parameter
    names (stacked leaves split along their first axis); a missing or
    extra name raises."""
    state = {}
    for name, leaf in _flatten(tree):
        t = _to_torch(leaf)
        top, _, rest = name.partition(".")
        if top in STACKED:
            for i in range(t.shape[0]):
                state[f"{top}.{i}.{rest}"] = t[i]
        else:
            state[name] = t
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, extra {extra}")
    return state


def opt_state_from_jax(cfg: ModelConfig, state: dict, device="cuda", mesh=None,
                       rules=None) -> dict:
    """The port's optimizer state (``repro_torch.train.init_opt_state``'s
    layout) from the reference's ``{"m", "v", "step"}`` with numpy leaves:
    ``m`` and ``v`` map by the names of :func:`params_from_jax` and must
    be f32 of the parameters' shapes.  With a multi-process ``mesh`` and
    ``rules``, the moments are laid out as :func:`params_from_jax` lays
    out the parameters (``models.partition.shard_opt_state``); the device
    is then the mesh's."""
    if mesh is not None:
        from .models.layers import MetaGenerator
        from .models.partition import shard_opt_state

        shapes = Model(cfg, MetaGenerator())  # the parameters' names and shapes
        return shard_opt_state(opt_state_from_jax(cfg, state, "cpu"), shapes, mesh, rules)
    dev = resolve_device(device)
    model = Model(cfg, torch.Generator(device=dev).manual_seed(0))
    shapes = {k: p.shape for k, p in model.named_parameters()}
    out = {"step": torch.as_tensor(np.asarray(state["step"]), dtype=torch.int32).to(dev)}
    for key in ("m", "v"):
        named = _named_leaves(state[key], model)
        for name, t in named.items():
            if t.dtype != torch.float32 or t.shape != shapes[name]:
                raise ValueError(f"{key}.{name}: {t.dtype} {tuple(t.shape)} where the "
                                 f"port keeps float32 {tuple(shapes[name])}")
        out[key] = {name: named[name].to(dev) for name in shapes}
    return out


def cache_from_jax(cfg: ModelConfig, cache: dict, device="cuda", mesh=None,
                   rules=None) -> dict:
    """The port's decode cache (``models.init_cache``'s tree) from the
    reference's ``init_cache`` tree with numpy leaves, e.g. a seeded
    non-zero cache that both packages decode from.  Every leaf must have
    the port's name, shape and type for the cache's batch and slots; a
    missing, extra or reshaped leaf raises.  With a multi-process ``mesh``
    and ``rules`` the cache comes back laid out by
    ``models.partition.shard_cache`` on the mesh's device."""
    from .models.model import init_cache

    if mesh is not None:
        from .models.partition import shard_cache

        return shard_cache(cache_from_jax(cfg, cache, "cpu"), mesh, rules)
    dev = resolve_device(device)
    leaves = dict(_flatten(cache))
    if cfg.family == "ssm":
        batch, slots = np.shape(leaves["state.s"])[1], 1
    else:  # the K/V rows or the ring: (..., B, slots, nkv, hd)
        kv = next(v for k, v in leaves.items() if k == "k" or k.endswith(("_k", ".k")))
        batch, slots = np.shape(kv)[-4:-2]
    shapes = dict(_flatten(init_cache(cfg, int(batch), int(slots), "meta")))
    if set(shapes) != set(leaves):
        raise ValueError(f"cache leaves differ: missing {sorted(set(shapes) - set(leaves))}, "
                         f"extra {sorted(set(leaves) - set(shapes))}")
    out = {}
    for name, leaf in leaves.items():
        t = _to_torch(leaf)
        if t.dtype != shapes[name].dtype or t.shape != shapes[name].shape:
            raise ValueError(f"cache {name}: {t.dtype} {tuple(t.shape)} where the port has "
                             f"{shapes[name].dtype} {tuple(shapes[name].shape)}")
        out[name] = t.to(dev)
    return _unflatten(cache, out)


def _unflatten(like, flat: dict, prefix=""):
    """``like``'s tree (dicts, lists) with the leaves of ``flat`` by dotted
    name."""
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}.") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}{i}.") for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda", mesh=None,
                    rules=None) -> Model:
    """The port's parameters (a :class:`~repro_torch.models.Model`) from the
    reference's ``init_params`` tree with numpy leaves, for every family.
    The stacked ``layers`` / ``enc`` / ``blocks`` leaves are split along
    their first axis into ``layers.<i>.…`` and so on (an MoE layer's
    expert leaves (L, e, d, ff) into (e, d, ff) each); ``tail`` is a list
    already; the others (``embed``, ``head``, ``ln_f``, ``ln_enc``,
    ``patch_proj``) map by name.  Every name and type must match: a
    missing, extra or retyped parameter raises.  With a multi-process
    ``mesh`` and ``rules`` the model comes back sharded
    (``models.partition.shard_params``: each rank keeps its blocks, on the
    mesh's device), ready for the sharded train step."""
    if mesh is not None:
        from .models.partition import shard_params

        return shard_params(params_from_jax(cfg, tree, "cpu"), mesh, rules)
    dev = resolve_device(device)
    model = Model(cfg, torch.Generator(device=dev).manual_seed(0))
    state = _named_leaves(tree, model)
    own = dict(model.named_parameters())
    for name, t in state.items():
        p = own[name]
        if t.dtype != p.dtype or t.shape != p.shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} where the port "
                             f"has {p.dtype} {tuple(p.shape)}")
        p.copy_(t)
    return model
