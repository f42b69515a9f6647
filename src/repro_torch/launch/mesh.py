"""Device meshes (the reference's ``launch/mesh.py``).

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis composes with "data" for batch/FSDP sharding so adding pods widens
the outer axis (elastic scaling reshards checkpoints, see
``repro_torch.checkpoint``).

A :class:`Mesh` names the axes of a grid of devices and has two forms:

* **multi-process**: ``torch.distributed`` is initialised with a world of
  ``prod(shape)`` ranks and each rank holds one device.  The mesh wraps
  ``init_device_mesh`` (``.device_mesh``); its axes give the process groups
  that collectives run over (:meth:`Mesh.group`) and the DTensor layouts of
  ``launch.sharding``.
* **one process**: the mesh lists devices (every local card, or CPU slots
  that a test asks for) and ``launch.sharding.data_parallel`` runs one
  batch slice on each.  This is the reference's ``make_host_mesh()`` inside
  its one server process.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """Named mesh axes over devices.  ``shape`` maps each axis name to its
    size in order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], devices=None,
                 device_mesh=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
        self.shape = OrderedDict(zip(axes, (int(n) for n in shape)))
        self.axis_names = tuple(axes)
        self.size = math.prod(self.shape.values())
        self.device_mesh = device_mesh
        self.devices = list(devices) if devices is not None else None
        self._groups: dict = {}

    @property
    def multi_process(self) -> bool:
        return self.device_mesh is not None

    @property
    def device(self) -> torch.device:
        """This rank's device (multi-process), else the first device."""
        if self.multi_process:
            kind = self.device_mesh.device_type
            return resolve_device("cpu" if kind == "cpu" else kind)
        return self.devices[0]

    def coordinate(self) -> dict:
        """This rank's index along each axis (multi-process meshes)."""
        self._need_processes("coordinate")
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (in mesh order)."""
        coord, out = self.coordinate(), 0
        for a in self._in_order(axes):
            out = out * self.shape[a] + coord[a]
        return out

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's index on
        every axis but ``axes``.  A group over several axes is made on its
        first request, which every rank of the mesh must make."""
        self._need_processes("group")
        axes = self._in_order(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            ranks = self.device_mesh.mesh
            keep = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in keep]
            rows = ranks.permute(*rest, *keep).reshape(-1, math.prod(self.shape[a] for a in axes))
            me = dist.get_rank()
            for row in rows.tolist():  # every rank makes every group, in order
                g = dist.new_group(row)
                if me in row:
                    self._groups[axes] = g
        return self._groups[axes]

    def _in_order(self, axes: Sequence[str]) -> tuple:
        missing = [a for a in axes if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh {dict(self.shape)}")
        return tuple(a for a in self.axis_names if a in axes)

    def _need_processes(self, what: str):
        if not self.multi_process:
            raise ValueError(f"Mesh.{what} needs a multi-process mesh (torch.distributed "
                             f"with a world of {self.size} ranks)")

    def __repr__(self):
        kind = "multi-process" if self.multi_process else f"one process over {self.devices}"
        return f"Mesh({dict(self.shape)}, {kind})"


def _local_devices(device) -> list:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape, axes, devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A mesh of ``shape`` named ``axes``.

    With ``devices`` given, a one-process mesh over them (``["cpu"] * n``
    gives n CPU slots).  Otherwise, when ``torch.distributed`` is
    initialised with a world of ``prod(shape)`` ranks, the multi-process
    mesh of ``device``'s type; else a one-process mesh over every local
    device of that type, which must number ``prod(shape)``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    size = math.prod(shape)
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) != size:
            raise ValueError(f"a {shape} mesh takes {size} devices, not {len(devices)}")
        return Mesh(shape, axes, devices=devices)
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == size:
        from torch.distributed.device_mesh import init_device_mesh

        return Mesh(shape, axes, device_mesh=init_device_mesh(dev.type, shape,
                                                              mesh_dim_names=axes))
    local = _local_devices(dev)
    if len(local) != size:
        raise RuntimeError(f"a {shape} mesh needs {size} devices: torch.distributed holds "
                           f"no world of that size and {len(local)} local {dev.type} "
                           "devices are present")
    return Mesh(shape, axes, devices=local)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != size:
        raise RuntimeError(f"the production mesh {shape} needs torch.distributed with a world "
                           f"of {size} ranks, one device each (world: {world})")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model: int = 1, device="cuda", devices: Optional[Sequence] = None) -> Mesh:
    """One-process debug mesh (tests, examples, the scorer's ``--shard``)
    over ``devices``, else every local card (``device="cpu"``: one CPU
    slot), as (data, model) = (n / model, model)."""
    devices = [resolve_device(d) for d in devices] if devices is not None \
        else _local_devices(device)
    n = len(devices)
    if n % model:
        raise ValueError(f"{n} devices do not split into model groups of {model}")
    return Mesh((n // model, model), ("data", "model"), devices=devices)


__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_production_mesh"]
