"""The sharded train step's collectives, written by hand (the layout the
reference's partitioner derives when its ``make_train_step`` is lowered
under ``sharding_context(mesh, TRAIN_RULES)``).

**Storage.**  ``models.partition.shard_params`` turns each parameter into
a DTensor placed by ``launch.sharding.placements_for`` of its spec: its
``"fsdp"`` dim split over the batch axes (pod, data), its ``"model_dim"``
/ ``"vocab"`` / ``"expert"`` dim over ``"model"``.  The model code never
computes on a DTensor: it reads a holder's parameters through
:func:`view`, which hands back plain tensors.

**FSDP.**  :func:`view` gathers each weight's batch-axis shards with
``all_gather_into_tensor`` along the dim they split (not always dim 0:
``wo``, ``w_down``, ``w_v``, ``w_o`` carry it on dim 1), inside the layer,
so that under remat the recomputation gathers again and no gathered weight
outlives its layer.  Its backward reduce-scatters the gradient over the
same ranks: they ran other rows of the batch.

**Tensor parallelism over "model".**  A block (attention, MLP, MoE, the
recurrent mixers) either splits its heads / channels / experts over the
model ranks, where its spec splits them and the head counts divide, or
gathers its model shards too and computes replicated: qwen2's 12 heads on
a 16-way axis store ``wq``'s columns split (``12 * 128`` divides) but
compute every head on every rank.  A model-axis gather's backward takes
the rank's slice of the gradient, which every rank computed alike.  Inside
a split block the activations move through the Megatron pair, :class:`Tp`:
``enter`` (identity forward, all-reduce backward) where a replicated input
meets split weights, ``reduce`` (all-reduce forward, identity backward)
after a row-parallel product; ``split``, ``gather`` and ``reduce_scatter``
move a channel dim between whole and split.

**Serving.**  The same prologue serves ``models.forward`` under
``SERVE_RULES`` (the weights 2-D over "model" x "data": each layer gathers
its "data" shards, nothing is reduced back) and ``models.decode_step``
under ``DECODE_RULES``, whose KV cache (``models.partition.shard_cache``)
splits its slots (``seq``, the encoder's ``frames``) over "model" and
keeps its kv heads whole.  A decode attention over such a cache is
sequence-parallel (:func:`split_softmax`): the rank that owns this step's
slot writes its K/V there (:func:`write_slot`), every rank attends all
heads over its own slots, and the partial max, sum of exponents and P.V
are combined over the model ranks; the cache's slots are never gathered.

Every collective is a plain ``torch.distributed`` call on the process
groups of the active mesh (``launch.mesh.Mesh.group``), so the same code
runs on gloo and NCCL worlds and on meta tensors over the dry run's fake
world, where ``torch.distributed.fsdp.fully_shard`` refuses meta
parameters.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from ..launch import sharding as S


def _all_gather(out, x, group):
    """``all_gather_into_tensor`` (its non-deprecated name where this torch
    has one: the same c10d op), looked up at the call."""
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(
        out, x, group=group)


def _reduce_scatter(out, x, group):
    (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
        out, x, group=group)


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor) or not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same tensor object on every call, so it
    can be an autograd leaf); any other tensor itself."""
    return t._local_tensor if is_dtensor(t) else t


# ----------------------------------------------------------------------------
# collectives along a dim
# ----------------------------------------------------------------------------

def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` concatenated along ``dim`` in group
    order."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    _all_gather(out, xm, group=group)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The rank's block along ``dim`` of the SUM of ``x`` over the ``n``
    ranks."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    _reduce_scatter(out, xm, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``x`` over the group, in a new tensor."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank, gathered with plain
    collectives over its mesh's groups, its innermost split first (a split
    over several mesh dims nests the later in the earlier); any other
    tensor itself.  DTensor's own ``full_tensor`` goes through functional
    collectives, which a gloo world on CUDA tensors does not survive."""
    if not is_dtensor(t):
        return t
    x, mesh = t._local_tensor.detach(), t.device_mesh
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if pl.is_shard():
            x = gather_dim(x, pl.dim, mesh.get_group(i), mesh.size(i))
    return x.contiguous()


class _AllGather(torch.autograd.Function):
    """Gather along ``dim``.  Backward: ``"sum"`` reduce-scatters the
    gradient (the ranks saw other data), ``"slice"`` takes the rank's block
    of it (the ranks computed it alike)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index, bwd):
        ctx.args = (dim, group, n, index, bwd)
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, index, bwd = ctx.args
        if bwd == "sum":
            return scatter_dim(g, dim, group, n), None, None, None, None, None
        return _block(g, dim, n, index), None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return scatter_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return gather_dim(g, dim, group, n), None, None, None


class _AllReduce(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    """The rank's block along ``dim`` of a replicated tensor; backward
    gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.args = (dim, group, n)
        return _block(x, dim, n, index)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return gather_dim(g, dim, group, n), None, None, None, None


class Tp:
    """The model axis of a block that splits its heads or channels: ``n``
    ranks in ``group``, this rank at ``index``.  :data:`NO_TP` (n = 1) is
    every method's identity."""

    def __init__(self, group=None, n: int = 1, index: int = 0):
        self.group, self.n, self.index = group, n, index

    def enter(self, x):
        return x if self.n == 1 else _Enter.apply(x, self.group)

    def reduce(self, x):
        return x if self.n == 1 else _AllReduce.apply(x, self.group)

    def split(self, x, dim):
        return x if self.n == 1 else _Split.apply(x, dim, self.group, self.n, self.index)

    def gather(self, x, dim, bwd="slice"):
        """Whole along ``dim``; ``bwd="sum"`` where the ranks consume the
        whole tensor differently (their gradients are partial)."""
        if self.n == 1:
            return x
        return _AllGather.apply(x, dim, self.group, self.n, self.index, bwd)

    def reduce_scatter(self, x, dim):
        return x if self.n == 1 else _ReduceScatter.apply(x, dim, self.group, self.n)


NO_TP = Tp()


# ----------------------------------------------------------------------------
# parameters: the per-layer prologue
# ----------------------------------------------------------------------------

def _mesh():
    mesh = S._CTX.mesh
    if mesh is None or not mesh.multi_process:
        raise RuntimeError("a sharded model runs under sharding_context(mesh, rules) on a "
                           "multi-process mesh")
    return mesh


def _split_axes(p) -> dict:
    """{tensor dim: mesh axes that split it, in mesh order} of a DTensor."""
    names = p.device_mesh.mesh_dim_names
    out: dict = {}
    for axis, pl in zip(names, p.placements):
        if pl.is_shard():
            out.setdefault(pl.dim, []).append(axis)
    return {d: tuple(a) for d, a in out.items()}


def spec_of(p) -> tuple:
    """A DTensor's spec (per dim: None, a mesh axis or a tuple of them)."""
    split = _split_axes(p)
    return tuple(None if d not in split else split[d] if len(split[d]) > 1 else split[d][0]
                 for d in range(p.ndim))


def gather_param(p: torch.Tensor, keep_model: bool = False) -> torch.Tensor:
    """``p``'s local shard with the shards of every axis but (with
    ``keep_model``) "model" gathered back, as a plain tensor: batch axes'
    backward reduce-scatters, the model axis' takes the rank's slice."""
    if not is_dtensor(p):
        return p
    x = local(p)
    mesh = _mesh()
    batch = set(S.mesh_batch_axes(mesh, S._CTX.rules))
    for dim, axes in sorted(_split_axes(p).items()):
        if keep_model and "model" in axes:
            continue
        kinds = {"sum" if a in batch else "slice" for a in axes}
        if len(kinds) > 1:
            raise ValueError(f"dim {dim} is split over batch and other axes {axes}")
        n = math.prod(mesh.shape[a] for a in axes)
        x = _AllGather.apply(x, dim, mesh.group(axes), n, mesh.index(axes), kinds.pop())
    return x


class View:
    """A holder's parameters as plain tensors, under their names."""

    def __init__(self, named: dict):
        self.__dict__.update(named)


def sharded(holder: nn.Module) -> bool:
    """Whether ``holder``'s own parameters are DTensors (a sharded model)."""
    return any(is_dtensor(p) for p in holder._parameters.values())


def view(holder: nn.Module, keep=()):
    """The per-layer prologue: ``holder`` itself when it is not sharded,
    else a :class:`View` of its own parameters gathered (``keep``: names
    that stay split over "model")."""
    if not sharded(holder):
        return holder
    return View({k: gather_param(p, k in keep) for k, p in holder._parameters.items()
                 if p is not None})


def model_tp() -> Tp:
    """The active mesh's model axis as a :class:`Tp`."""
    mesh = _mesh()
    n = mesh.shape.get("model", 1)
    if n == 1:
        return NO_TP
    return Tp(mesh.group(("model",)), n, mesh.coordinate()["model"])


def _all_split(holder, names, heads=None) -> bool:
    """Whether every parameter of ``names`` that ``holder`` has is computed
    on split over "model" (``launch.sharding.compute_split``)."""
    mesh = _mesh()
    return all(S.compute_split(spec_of(getattr(holder, k)), heads, mesh) for k in names
               if getattr(holder, k, None) is not None)


def attention(p, cfg):
    """(view, tp, kv_head) of an attention holder.  Split: ``wq``'s heads
    divide the model axis.  Its kv heads either divide it too (``kv_head``
    None: each rank projects its own), or each rank's query heads read one
    kv head, which it takes from the whole K and V (``kv_head``: its index;
    llama3-8b's 8 kv heads on 16 ranks).  Otherwise replicated (NO_TP)."""
    if not sharded(p):
        return p, NO_TP, None
    tp = model_tp()
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if not _all_split(p, ("wq", "wo"), hq):
        return view(p), NO_TP, None
    if _all_split(p, ("wk", "wv"), hkv):
        return view(p, ("wq", "wk", "wv", "wo", "bq", "bk", "bv")), tp, None
    local, group = hq // tp.n, hq // hkv
    if group % local == 0:
        return view(p, ("wq", "wo", "bq")), tp, tp.index * local // group
    return view(p), NO_TP, None


def _block_view(p, names):
    """(view, tp): split when every one of ``names`` is split over
    "model" (all of the holder's model shards kept)."""
    if not sharded(p):
        return p, NO_TP
    if _all_split(p, names):
        return view(p, tuple(p._parameters)), model_tp()
    return view(p), NO_TP


def mlp(p):
    return _block_view(p, ("w_gate", "w_up", "w_down", "b_up"))


def moe(p):
    """(view, tp, first local expert, groups a rank routes): experts split
    over "model" (the router's logits gathered whole), one capacity group
    a rank (its batch is one batch shard)."""
    if not sharded(p):
        g = S.num_batch_shards()
        return p, NO_TP, 0, g
    if _all_split(p, ("w_gate", "w_up", "w_down")):
        v, tp = view(p, ("w_gate", "w_up", "w_down")), model_tp()
        return v, tp, tp.index * v.w_gate.shape[0], 1
    return view(p), NO_TP, 0, 1


def rglru(p):
    return _block_view(p, ("w_x", "w_y", "conv_w", "w_gate_a", "w_gate_x", "w_o"))


def time_mix(p, cfg):
    """Split when the heads divide the model axis and the projections are
    split over it."""
    if not sharded(p):
        return p, NO_TP
    heads = cfg.d_model // cfg.rwkv_head_dim
    if _all_split(p, ("w_r", "w_k", "w_v", "w_g", "w_o"), heads):
        return view(p, ("w_r", "w_k", "w_v", "w_g", "w_o")), model_tp()
    return view(p), NO_TP


def channel_mix(p):
    return _block_view(p, ("w_k", "w_v", "w_r"))


# ----------------------------------------------------------------------------
# vocabulary parallelism
# ----------------------------------------------------------------------------

def top(model: nn.Module):
    """(view of the model's own parameters, tp of the vocabulary): the
    vocabulary is split when ``embed``'s rows are (and ``head``'s columns,
    untied)."""
    if not sharded(model):
        return model, NO_TP
    names = ("embed",) if model.cfg.tied_embeddings else ("embed", "head")
    if _all_split(model, names):
        return view(model, names), model_tp()
    return view(model), NO_TP


def embed(table: torch.Tensor, tokens: torch.Tensor, tp: Tp) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``; with the vocabulary split, the
    rank's rows (others zero) summed over the model ranks."""
    if tp.n == 1:
        return table[tokens]
    rows = table.shape[0]
    at = tokens - tp.index * rows
    hit = (at >= 0) & (at < rows)
    out = table[at.clamp(0, rows - 1)].masked_fill(~hit[..., None], 0)
    return tp.reduce(out)


class _VocabParallelNll(torch.autograd.Function):
    """Next-token NLL from logits split over the vocabulary (the rank's
    columns start at ``v0``): the f32 max and sum of exponents are
    all-reduced over the model ranks, as is the target's logit.  Backward:
    ``(softmax - onehot) * g`` on the rank's columns, recomputed in f32 and
    cast to the logits' type, as ``_CEBf16`` computes it whole."""

    @staticmethod
    def forward(ctx, logits, targets, v0, group):
        lf = logits.float()
        m = lf.amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = torch.exp(lf - m).sum(-1, keepdim=True)
        dist.all_reduce(se, group=group)
        lse = (m + torch.log(se))[..., 0]
        at = targets - v0
        hit = (at >= 0) & (at < logits.shape[-1])
        t = lf.gather(-1, at.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        t = torch.where(hit, t, t.new_zeros(()))
        dist.all_reduce(t, group=group)
        ctx.save_for_backward(logits, at, hit, lse)
        return lse - t

    @staticmethod
    def backward(ctx, g):
        logits, at, hit, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, at.clamp(0, logits.shape[-1] - 1)[..., None],
                       -hit[..., None].to(p.dtype))
        return (p * g[..., None]).to(logits.dtype), None, None, None


def vocab_parallel_nll(logits, targets, tp: Tp):
    return _VocabParallelNll.apply(logits, targets, tp.index * logits.shape[-1], tp.group)


# ----------------------------------------------------------------------------
# decode over a cache whose slots are split over "model"
# ----------------------------------------------------------------------------

def slots_tp(leaf) -> Tp:
    """The model ranks that split the slots of a cache leaf (its dim -3:
    the K/V rows by position, a ring's slots, the encoder's frames), as a
    :class:`Tp`: the model axis where the leaf is a DTensor whose spec
    splits that dim over "model", else :data:`NO_TP`."""
    if not is_dtensor(leaf):
        return NO_TP
    axes = _split_axes(leaf).get(leaf.ndim - 3, ())
    if not axes:
        return NO_TP
    if axes != ("model",):
        raise ValueError(f"a cache's slots split over {axes}: only 'model' is supported")
    return model_tp()


def local_tree(tree):
    """A cache tree (dicts, lists) with each DTensor leaf's local block: the
    tensors the decode writes in place."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [local_tree(v) for v in tree]
    return local(tree)


def whole_tree(tree):
    """A tree of tensors with every DTensor leaf gathered whole
    (:func:`whole`): a sharded cache on every rank."""
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [whole_tree(v) for v in tree]
    return whole(tree)


def write_slot(cache: torch.Tensor, slot: torch.Tensor, value: torch.Tensor, slots: Tp):
    """``cache[r, slot[r]] = value[r]`` for every row ``r`` whose global slot
    this rank owns: ``cache`` (B, T / n, ...) holds slots ``index * T / n``
    onward of ``slots``' ``n`` ranks, so slot ``s`` belongs to rank ``s //
    (T / n)`` at local index ``s % (T / n)``.  Rows owned elsewhere write
    their own value back (no data-dependent indexing: the same ops on a
    meta trace)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    tl = cache.shape[1]
    at = slot % tl
    mine = (slot // tl) == slots.index
    mine = mine.reshape(mine.shape + (1,) * (value.ndim - 1))
    cache[rows, at] = torch.where(mine, value.to(cache.dtype), cache[rows, at])


def split_softmax(scores: torch.Tensor, v: torch.Tensor, slots: Tp) -> torch.Tensor:
    """Softmax attention over slots split across ``slots``' ranks.  scores:
    (B, nkv, G, 1, T / n) f32 over this rank's slots, masked with -1e30; v:
    (B, T / n, nkv, hd).  The masked partial max is all-reduced (MAX) over
    the ranks; each rank's sum of exponents and unnormalised P.V (f32) are
    summed over them and divided.  A rank whose slots are all masked adds
    exactly 0.  Returns (B, 1, nkv * G, hd) in ``v``'s type."""
    m = scores.amax(-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=slots.group)
    e = torch.exp(scores - m)
    part = torch.cat([e.sum(-1, keepdim=True),
                      torch.einsum("bngst,btnh->bngsh", e, v.float())], dim=-1)
    dist.all_reduce(part, group=slots.group)
    out = part[..., 1:] / part[..., :1]                  # (B, nkv, G, 1, hd)
    b, nkv, g, s, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nkv * g, hd).to(v.dtype)


def batch_total(count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the batch axes' ranks (no gradient): a loss
    over the global (micro)batch divides by it."""
    mesh = _mesh()
    axes = S.mesh_batch_axes(mesh, S._CTX.rules)
    if not axes or math.prod(mesh.shape[a] for a in axes) == 1:
        return count
    return all_reduce(count.detach(), mesh.group(axes))


__all__ = ["Tp", "NO_TP", "View", "is_dtensor", "local", "whole", "gather_dim", "scatter_dim",
           "all_reduce", "gather_param", "view", "sharded", "model_tp", "spec_of",
           "attention", "mlp", "moe", "rglru", "time_mix", "channel_mix", "top", "embed",
           "vocab_parallel_nll", "batch_total", "slots_tp", "local_tree", "whole_tree",
           "write_slot", "split_softmax"]
