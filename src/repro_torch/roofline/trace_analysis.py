"""What one rank's step dispatches: FLOPs, an HBM-byte proxy and collective
bytes, counted op by op on the aten ops that the step runs (the
counterpart of the reference's ``hlo_analysis.py``, which reads compiled
XLA HLO).

The port has no HLO and no while loops to expand: a trace on meta tensors
runs every layer, every microbatch and every recomputed forward, so the
count is what the step dispatches.  :class:`CostMode` is a
``TorchDispatchMode``; :func:`analyze` runs a function under it.

Byte rules (the reference's, ``hlo_analysis.py``):

* matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions)
  — operand + result bytes; their FLOPs as ``torch.utils.flop_counter``
  counts them;
* other materialising ops — 2 x result bytes (one write, one read by the
  consumer); an op that writes into part of an existing tensor
  (``index_put_``, ``copy_`` into a slice) — 2 x the bytes written;
* views, ``t``, ``expand``, ``reshape``, ``detach``, the ``empty*``
  allocations and constant fills (``zeros``, ``full``, ``arange``: the
  reference's ``broadcast``, ``constant``, ``iota``) — no bytes;
* collectives — ``allreduce*`` 2 x its bytes, ``allgather*`` 1 x its
  gathered output, ``reduce_scatter*`` 1 x its input (the operand, as the
  reference charges a reduce-scatter), ``alltoall*`` and ``broadcast_``
  1 x, each recorded in ``collective_ops`` by name and, in
  :attr:`CostMode.links`, by the link its group crosses (``hw.link_bw``; a
  group of one rank crosses none: ``"local"``).  An op's tensors and its
  process group are read by their names in its schema (:data:`_COLLECTIVES`),
  not by position: the ops order their arguments differently.

**Kernels count as what the card launches.**  On meta tensors the model's
kernel ops (K5, K6, K7 and their backwards) run no plain version: they
return empty outputs and call :func:`charge` with their shape, whose
``roofline.kernel_work`` FLOPs and bytes every active
:class:`CostMode` adds to its cost and to :attr:`CostMode.kernels`.

Memory: :attr:`CostMode.peak_bytes` is the peak of the bytes of the
storages made under the mode and still alive (a weak-reference counter on
each new storage); tensors made before the mode (the step's arguments) are
the caller's to add.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from . import hw, kernel_work


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_ops: dict = dataclasses.field(default_factory=dict)
    unresolved_whiles: list = dataclasses.field(default_factory=list)

    def __add__(self, o):
        co = dict(self.collective_ops)
        for k, v in o.collective_ops.items():
            co[k] = co.get(k, 0.0) + v
        return Cost(
            self.flops + o.flops,
            self.bytes + o.bytes,
            self.collective_bytes + o.collective_bytes,
            co,
            self.unresolved_whiles + o.unresolved_whiles,
        )

    def scaled(self, f: float):
        return Cost(
            self.flops * f, self.bytes * f, self.collective_bytes * f,
            {k: v * f for k, v in self.collective_ops.items()},
            self.unresolved_whiles,
        )


_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
             "convolution_backward"}
_NO_BYTES = {
    "t", "expand", "reshape", "view", "_unsafe_view", "detach", "alias", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "scalar_tensor", "arange", "_local_scalar_dense",
}
# writes into part of an existing tensor: (argument index of the values)
_PARTIAL_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
                   "copy_": 1, "scatter_": 3, "masked_scatter_": 2}
# c10d op -> (the schema argument whose tensors are charged, factor): the
# all-reduce's tensors (in and out), the all-gather's gathered output, the
# reduce-scatter's input
_COLLECTIVES = {"allreduce_": ("tensors", 2.0), "allreduce_coalesced_": ("tensors", 2.0),
                "allgather_": ("output_tensors", 1.0),
                "_allgather_base_": ("output_tensor", 1.0),
                "allgather_into_tensor_coalesced_": ("outputs", 1.0),
                "allgather_coalesced_": ("output_lists", 1.0),
                "reduce_scatter_": ("input_tensors", 1.0),
                "_reduce_scatter_base_": ("input_tensor", 1.0),
                "reduce_scatter_tensor_coalesced_": ("inputs", 1.0),
                "alltoall_": ("output_tensors", 1.0), "alltoall_base_": ("output", 1.0),
                "broadcast_": ("tensors", 1.0)}

_ACTIVE: list = []


def charge(kernel: str, **shape) -> None:
    """One launch of ``kernel`` at ``shape`` (``kernel_work.work``'s
    arguments), added to every active :class:`CostMode`: a kernel op's meta
    branch calls it where the card would launch the kernel."""
    flops, byts, _ = kernel_work.work(kernel, **shape)
    for mode in _ACTIVE:
        mode._charge(kernel, flops, byts)


def _tensors(x, out=None) -> list:
    """The tensors of an argument tree (lists, tuples, dicts), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _by_name(func, args, kwargs) -> dict:
    """An op's arguments by their names in its schema."""
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    return named


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ops whose meta outputs are not a function of their inputs' metadata
_NO_CACHE = {"_local_scalar_dense", "item", "nonzero", "masked_select", "unique"}


def _signature(x):
    """Hashable metadata of an argument tree: a tensor as its shape,
    strides, type and device; anything else as itself."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    return x


def _meta_spec(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.stride(), t.dtype)


# the dispatch keys of Python modes: an allocation made past them reaches no
# mode (the flop counter below need not see it)
_PAST_MODES = (torch._C.DispatchKeySet(torch._C.DispatchKey.Python)
               | torch._C.DispatchKeySet(torch._C.DispatchKey.PythonTLSSnapshot))


def _from_spec(spec) -> torch.Tensor:
    shape, stride, dtype = spec
    with torch._C._ExcludeDispatchKeyGuard(_PAST_MODES):
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class CostMode(TorchDispatchMode):
    """Counts what the ops run under it dispatch.  After the block:
    :attr:`cost` (a :class:`Cost`), :attr:`kernels` ({kernel: {"launches",
    "flops", "bytes"}}), :attr:`links` ({"nvlink" | "net" | "local":
    collective bytes}), :attr:`op_links` ({collective op: {link: bytes}}),
    :attr:`ops` ({aten op: [calls, flops, bytes]}) and :attr:`peak_bytes`."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernels: dict = {}
        self.links: dict = collections.Counter()
        self.op_links: dict = collections.defaultdict(collections.Counter)
        self.ops: dict = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: set = set()
        self._cache: dict = {}
        self._functional: dict = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def absorb(self, other: "CostMode", times: float = 1.0) -> None:
        """Add ``times`` x what ``other`` counted (its cost, kernels, links
        and ops; not its memory): a loop body traced once and counted for
        its trip count."""
        self.cost = self.cost + other.cost.scaled(times)
        for k, v in other.kernels.items():
            mine = self.kernels.setdefault(k, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            for key in mine:
                mine[key] += v[key] * times
        for link, b in other.links.items():
            self.links[link] += b * times
        for op, links in other.op_links.items():
            for link, b in links.items():
                self.op_links[op][link] += b * times
        for op, (n, fl, by) in other.ops.items():
            rec = self.ops[op]
            rec[0] += n * times
            rec[1] += fl * times
            rec[2] += by * times

    def _charge(self, kernel, flops, byts):
        k = self.kernels.setdefault(kernel, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += byts
        self.cost.flops += flops
        self.cost.bytes += byts

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live_bytes += n
            weakref.finalize(st, self._free, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live_bytes -= n

    def _run(self, func, args, kwargs, ins):
        """``func(*args, **kwargs)``; on meta inputs a functional op's
        outputs come from the first call with the same metadata (shapes,
        strides, types and the other arguments), since a meta op computes
        nothing else: the layers and the optimizer's chunks repeat theirs.
        Ops with FLOPs always run, so that a ``FlopCounterMode`` under this
        mode counts each of them."""
        if not (self._cacheable(func) and all(t.is_meta for t in ins)):
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        spec = self._cache.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self._cache[key] = (False, _meta_spec(out))
            elif isinstance(out, tuple) and all(isinstance(t, torch.Tensor) for t in out):
                self._cache[key] = (True, tuple(_meta_spec(t) for t in out))
            return out
        many, spec = spec
        return tuple(_from_spec(sp) for sp in spec) if many else _from_spec(spec)

    def _cacheable(self, func) -> bool:
        ok = self._functional.get(func)
        if ok is None:
            schema = func._schema
            ok = (func.namespace == "aten" and not schema.is_mutable and not func.is_view
                  and not any(r.alias_info for r in schema.returns)
                  and torch.Tag.nondeterministic_seeded not in func.tags
                  and func._overloadpacket not in flop_registry
                  and func._overloadpacket.__name__ not in _NO_CACHE)
            self._functional[func] = ok
        return ok

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = self._run(func, args, kwargs, ins)
        outs = _tensors(out)
        name = func._overloadpacket.__name__
        flops = byts = 0.0
        if func.namespace == "c10d":
            if name in _COLLECTIVES:
                arg, factor = _COLLECTIVES[name]
                named = _by_name(func, args, kwargs)
                size = sum(_nbytes(t) for t in _tensors(named[arg]))
                cb = size * factor
                group = dist.ProcessGroup.unbox(named["process_group"])
                ranks = dist.get_process_group_ranks(group)
                link = "nvlink" if hw.link_bw(ranks) == hw.NVLINK_BW else "net"
                link = "local" if len(ranks) == 1 else link
                self.links[link] += cb
                self.op_links[name][link] += cb
                self.cost.collective_bytes += cb
                self.cost.collective_ops[name] = self.cost.collective_ops.get(name, 0.0) + cb
                byts = size
        elif func._overloadpacket in flop_registry:
            flops = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            if name in _PRODUCTS:
                byts = sum(_nbytes(t) for t in ins + outs)
            else:
                byts = 2.0 * sum(_nbytes(t) for t in outs)
        elif name in _PARTIAL_WRITES:
            at = _PARTIAL_WRITES[name]
            src = args[at] if len(args) > at else None
            byts = 2.0 * (_nbytes(src) if isinstance(src, torch.Tensor)
                          else sum(_nbytes(t) for t in outs))
        elif not (func.is_view or name in _NO_BYTES):
            byts = 2.0 * sum(_nbytes(t) for t in outs)
        self.cost.flops += flops
        self.cost.bytes += byts
        rec = self.ops[func]
        rec[0] += 1
        rec[1] += flops
        rec[2] += byts
        self._track(outs)
        return out


def analyze(fn, *args, **kw) -> Cost:
    """The :class:`Cost` of ``fn(*args, **kw)`` (run once, under
    :class:`CostMode`)."""
    with CostMode() as mode:
        fn(*args, **kw)
    return mode.cost


__all__ = ["Cost", "CostMode", "analyze", "charge"]
