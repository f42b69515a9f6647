"""Atomic, async checkpointing of training state (the reference's
``checkpoint/checkpoint.py``), in the reference's layout::

    <root>/step_00000420/
        manifest.json     # step, extra, and per leaf: path, file, shape, dtype
        leaf_00000.npy    # one file per leaf (np.save; bf16 as a uint16 view)
        ...

so a checkpoint written by one package restores in the other.  A tree is
nested dicts (keys in sorted order, as ``jax.tree_util`` flattens them),
lists and tuples of tensors or numpy arrays; an ``nn.Module`` stands for
its ``state_dict()``.  A leaf's path is its keys joined by ``/``.

* atomic — written to ``<root>/.tmp_<step>`` then ``os.replace``'d, so a
  partly written checkpoint is never visible;
* async — :class:`AsyncCheckpointer` copies the tree to host memory on the
  caller's thread, then writes on a worker thread.

Elastic resharding: the checkpoint carries no device layout.  A DTensor
leaf is saved whole (gathered by collectives: every rank of its
mesh calls ``save``, and global rank 0 writes), and ``restore(shardings=)``
brings each leaf back as a DTensor on the current mesh, so a checkpoint
saved at one world size restores at another.  Restoring onto sharded state
needs no ``shardings``: a DTensor target leaf (a sharded model's parameter
or moment) comes back laid out as it is, and a module whose parameters are
DTensors is loaded in place, each rank its own blocks.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree, prefix=()):
    """(path tuple, leaf) pairs in the reference's order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, prefix + (str(i),))
    else:
        yield prefix, tree


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _whole(leaf):
    """A DTensor leaf gathered whole (collectives over its mesh's groups,
    ``train.sharded.whole``), else the leaf."""
    from ..train.sharded import whole

    return whole(leaf)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array np.save writes (bf16 as its uint16 bits),
    with its logical type name."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        name = str(t.dtype).removeprefix("torch.")
        return t.numpy(), name
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array from elsewhere
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _snapshot(tree):
    """The tree with every leaf copied to host memory."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _whole(tree).detach().to("cpu", copy=True)
    return np.array(tree)


def save(root: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint directory.
    With DTensor leaves every rank calls it; rank 0 writes, and the others
    wait for the checkpoint to be in place."""
    final = os.path.join(root, f"step_{step:08d}")
    if any(_is_dtensor(leaf) for _, leaf in _flatten(tree)):
        tree = _snapshot(tree)  # gathers every DTensor on every rank
        if dist.get_rank() != 0:
            dist.barrier()
            return final
        _write(root, step, tree, extra)
        dist.barrier()
        return final
    return _write(root, step, tree, extra)


def _write(root: str, step: int, tree, extra: Optional[dict]) -> str:
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp_{step:08d}")
    final = os.path.join(root, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _host(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"path": "/".join(path), "file": fn,
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncCheckpointer:
    """Copies the tree to host memory on the caller's thread (so later
    in-place updates cannot reach the checkpoint), writes it on a thread."""

    def __init__(self, root: str, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        host_tree = _snapshot(tree)

        def work():
            try:
                save(self.root, step, host_tree, extra)
                self.last_saved = step
                cleanup(self.root, self.keep_last)
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _steps(root: str) -> list:
    return sorted(
        d for d in os.listdir(root)
        if d.startswith("step_") and os.path.isfile(os.path.join(root, d, "manifest.json"))
    )


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in _steps(root)]
    return max(steps) if steps else None


def cleanup(root: str, keep_last: int):
    steps = _steps(root)
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def _load_leaf(ckpt: str, entry: dict, key: str, expect) -> torch.Tensor:
    arr = np.load(os.path.join(ckpt, entry["file"]))
    dtype = entry["dtype"]
    if str(arr.dtype) != dtype:
        arr = arr.view(np.uint16 if dtype == "bfloat16" else np.dtype(dtype))
    if expect is not None and tuple(arr.shape) != tuple(expect):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(expect)}")
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _like(t: torch.Tensor, target) -> torch.Tensor:
    """``t`` (the whole leaf) as a DTensor laid out as the DTensor
    ``target``, on its device."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(target.device), target.device_mesh, target.placements,
                             src_data_rank=None)


def _distribute(t: torch.Tensor, sharding, key: str):
    """``t`` (the whole leaf, loaded on every rank) as a DTensor laid out
    by ``sharding`` (a ``launch.sharding.NamedSharding``); each rank keeps
    its own shard of its own copy, so nothing crosses the wire."""
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    if not mesh.multi_process:
        raise ValueError(f"{key}: restoring onto shardings needs a multi-process mesh")
    return distribute_tensor(t.to(mesh.device), mesh.device_mesh, sharding.placements,
                             src_data_rank=None)


def restore(root: str, step: int, target_tree, shardings=None):
    """Restore into the structure of ``target_tree``.  A tensor leaf comes
    back on its target's device, a numpy leaf as a tensor on the CPU; an
    ``nn.Module`` target is loaded in place (each parameter's type must
    match) and returned.  ``shardings``: optional matching tree of
    ``launch.sharding.NamedSharding`` on the *current* mesh (e.g. from
    ``models.partition.param_shardings``) — each leaf comes back as a
    DTensor laid out so, the elastic-resharding path; the target is then
    a tree of tensors or arrays, not a module.  Without ``shardings`` a
    DTensor target leaf comes back as a DTensor of its layout (a sharded
    module is loaded in place).  Returns (tree, manifest)."""
    if shardings is not None and isinstance(target_tree, torch.nn.Module):
        raise TypeError("restoring onto shardings takes a tree of tensors (a module's "
                        "state_dict()), not a module")
    ckpt = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}

    def load(tree, prefix, sh=None):
        if isinstance(tree, torch.nn.Module):
            state = load(tree.state_dict(), prefix)
            with torch.no_grad():
                for name, t in tree.state_dict().items():
                    if state[name].dtype != t.dtype:
                        raise ValueError(f"{'/'.join(prefix + (name,))}: checkpoint "
                                         f"type {state[name].dtype} != {t.dtype}")
                    if _is_dtensor(t):
                        t._local_tensor.copy_(state[name]._local_tensor)
                    else:
                        t.copy_(state[name])
            return tree
        if isinstance(tree, dict):  # leaves in the reference's (sorted) order
            done = {k: load(tree[k], prefix + (str(k),), None if sh is None else sh[k])
                    for k in sorted(tree)}
            return {k: done[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(load(v, prefix + (str(i),), None if sh is None else sh[i])
                              for i, v in enumerate(tree))
        key = "/".join(prefix)
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _load_leaf(ckpt, by_path[key], key, getattr(tree, "shape", None))
        if sh is not None:
            return _distribute(t, sh, key)
        if _is_dtensor(tree):
            return _like(t, tree)
        return t.to(tree.device) if isinstance(tree, torch.Tensor) else t

    return load(target_tree, (), shardings), manifest


def restore_latest(root: str, target_tree, shardings=None):
    step = latest_step(root)
    if step is None:
        return None, None
    return restore(root, step, target_tree, shardings)
