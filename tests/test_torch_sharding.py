"""The port's mesh layer (``repro_torch.launch.mesh``, ``launch.sharding``,
``models.partition``) and the MoE dispatch groups against the reference.

* The rule tables equal the reference's; ``spec_for`` equals the
  reference's on the same mesh shapes, logical axes and dims (the cases of
  ``tests/test_dryrun_infra.py`` and seeded random cases on meshes (2, 8),
  (4,) and (2, 2, 2)), and so does ``mesh_batch_shards``.  The reference
  side runs in a subprocess on 16 forced host devices, as its own mesh
  tests do.
* ``param_logical_axes`` of the port's model equals the reference's for
  every leaf of every ``ARCHS`` entry (smoke config): the port's leaves are
  the reference's stacked leaves split over the layers, so a leaf's spec
  is the reference's with the stacked axes dropped from the left.
* ``moe_mlp`` under ``sharding_context`` with a (4,) data mesh and
  ``TRAIN_RULES`` routes each quarter of the batch alone, with its own
  capacity, as the reference's does on 4 forced devices: at f32 on the same
  input bits the kept (token, choice) pairs are the reference's (by the
  reference's own routing steps a group) and the output is within 2e-5 of
  the largest |output| (``tests/test_torch_models.py``'s f32 rule), while
  the groups drop other pairs than one group would.  Outside a context the
  output is bit for bit the single-group dispatch's.
* The multi-process mesh (4 gloo ranks): its groups, indices and the
  DTensor layout of a dim split over ("data", "model"), data-major as a
  tuple entry of ``PartitionSpec`` lays it out.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.launch.sharding as RS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models.partition import param_logical_axes as jax_param_logical_axes
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.interop import _to_torch
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.models.layers import MoE, gelu, moe_capacity, moe_mlp, moe_route
from repro_torch.models.model import STACKED
from repro_torch.models.partition import param_logical_axes, param_shardings

from torch_ranks import finish, run_ranks, run_reference

TABLES = ("TRAIN_RULES", "SERVE_RULES", "DECODE_RULES", "TRAIN_RULES_SP", "DECODE_RULES_1D")
MESHES = {"2x8": ((2, 8), ("data", "model")), "4": ((4,), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
NAMES = sorted(S.TRAIN_RULES) + ["unknown", None]
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 64)
# the MoE dispatch case: 4 experts, top 2, capacity factor 1 over 8 rows of
# 6 tokens, so each of the 4 groups holds 12 tokens and 6 slots an expert
MOE_OVER = dict(num_experts=4, num_experts_per_tok=2, moe_capacity_factor=1.0,
                dtype="float32")
MOE_SHAPE = (8, 6)


def _cases():
    """(mesh, table, logical, dims): the dry-run test's three, then 60
    seeded random cases a mesh."""
    out = [("2x8", "TRAIN_RULES", ("batch", "seq", "heads"), (4, 16, 12)),
           ("2x8", "TRAIN_RULES", ("batch", "seq", "mlp"), (4, 16, 64)),
           ("2x8", "TRAIN_RULES", ("mlp", "vocab"), (64, 64))]
    rng = np.random.default_rng(0)
    for mesh in MESHES:
        for _ in range(60):
            rank = int(rng.integers(1, 5))
            out.append((mesh, TABLES[int(rng.integers(len(TABLES)))],
                        tuple(NAMES[int(i)] for i in rng.integers(len(NAMES), size=rank)),
                        tuple(int(DIMS[int(i)]) for i in rng.integers(len(DIMS), size=rank))))
    return out


REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch import sharding as S
from repro.launch.mesh import make_mesh
from repro.models.layers import moe_mlp, moe_params

out = sys.argv[1]
cases, meshes, over, shape = (json.loads(a) for a in sys.argv[2:6])
built = {k: make_mesh(tuple(s), tuple(a), devices=jax.devices()[:int(np.prod(s))])
         for k, (s, a) in meshes.items()}
specs = []
for mesh, table, logical, dims in cases:
    spec = S.spec_for(tuple(logical), tuple(dims), getattr(S, table), built[mesh])
    specs.append([list(e) if isinstance(e, tuple) else e for e in spec])
shards = {k: {t: S.mesh_batch_shards(m, getattr(S, t)) for t in
              ("TRAIN_RULES", "SERVE_RULES", "DECODE_RULES")} | {"default": S.mesh_batch_shards(m)}
          for k, m in built.items()}
cfg = get_smoke_config("olmoe-1b-7b", **over)
p = moe_params(jax.random.key(3), cfg)
x = jax.random.normal(jax.random.key(4), tuple(shape) + (cfg.d_model,), jnp.float32)
# a fresh function a trace: num_batch_shards() is read while tracing and is
# not part of jit's cache key
one = jax.jit(lambda p, x: moe_mlp(p, cfg, x))(p, x)
with S.sharding_context(built["4"], S.TRAIN_RULES):
    grouped = jax.jit(lambda p, x: moe_mlp(p, cfg, x))(p, x)
np.savez(out + "/moe.npz", x=np.asarray(x), one=np.asarray(one), grouped=np.asarray(grouped),
         **{k: np.asarray(v) for k, v in p.items()})
print(json.dumps({"specs": specs, "shards": shards}))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding")
    cases = _cases()
    proc = run_reference(REFERENCE, 16, args=[str(out), json.dumps(cases), json.dumps(MESHES),
                                              json.dumps(MOE_OVER), json.dumps(MOE_SHAPE)])
    res = json.loads(finish(proc).strip().splitlines()[-1])
    res["cases"] = cases
    res["moe"] = dict(np.load(out / "moe.npz"))
    return res


def _port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


# ----------------------------------------------------------------------------
# the rules, spec_for, mesh_batch_shards
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_are_the_references(table):
    assert getattr(S, table) == getattr(RS, table)


def test_spec_for_matches_reference(reference):
    meshes = {k: _port_mesh(k) for k in MESHES}
    for (mesh, table, logical, dims), want in zip(reference["cases"], reference["specs"]):
        got = S.spec_for(logical, dims, getattr(S, table), meshes[mesh])
        assert got == _as_tuple(want), (mesh, table, logical, dims)


def test_spec_for_dryrun_cases():
    """``tests/test_dryrun_infra.py``'s cases on the port: 12 heads on a
    model axis of 8 stay replicated, an mlp of 64 shards, no axis twice."""
    mesh = _port_mesh("2x8")
    assert S.spec_for(("batch", "seq", "heads"), (4, 16, 12), S.TRAIN_RULES, mesh) == (
        "data", None, None)
    assert S.spec_for(("batch", "seq", "mlp"), (4, 16, 64), S.TRAIN_RULES, mesh)[2] == "model"
    s3 = S.spec_for(("mlp", "vocab"), (64, 64), S.TRAIN_RULES, mesh)
    assert [a for a in s3 if a is not None].count("model") <= 1
    with S.sharding_context(mesh, S.TRAIN_RULES):
        assert S.spec_for(("batch",), (4,)) == ("data",)
        assert S.num_batch_shards() == 2 and S.active()
    assert not S.active() and S.num_batch_shards() == 1


def test_mesh_batch_shards_match_reference(reference):
    for name, want in reference["shards"].items():
        mesh = _port_mesh(name)
        got = {t: S.mesh_batch_shards(mesh, getattr(S, t)) for t in want if t != "default"}
        got["default"] = S.mesh_batch_shards(mesh)
        assert got == want, name


# ----------------------------------------------------------------------------
# the parameters' logical axes
# ----------------------------------------------------------------------------

def _reference_axes(rcfg) -> dict:
    """The reference's logical axes a leaf under the port's names, with the
    stacked axes dropped (the port keeps each layer's leaf apart)."""
    shapes = jax.eval_shape(lambda: jax_init_params(rcfg, jax.random.key(0)))
    axes = jax_param_logical_axes(shapes)
    flat_axes = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_shapes = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    out = {}
    for path, spec in flat_axes:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        shape = flat_shapes[path].shape
        if keys[0] in STACKED:
            for i in range(shape[0]):
                out[".".join([keys[0], str(i)] + keys[1:])] = tuple(spec)[1:]
        else:
            out[".".join(keys)] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", ARCHS + ["joinml-oracle"])
def test_param_logical_axes_match_reference(arch):
    over = {"num_layers": 5} if arch == "recurrentgemma-9b" else {}
    want = _reference_axes(jax_smoke_config(arch, **over))
    model = init_params(get_smoke_config(arch, **over), device="cpu")
    got = param_logical_axes(model)
    assert set(got) == set(want)
    for name, p in model.named_parameters():
        assert got[name] == want[name], name
        assert len(got[name]) == p.ndim, name


def test_param_shardings_place_fsdp_and_tensor_parallel_axes():
    """On a (2, 2) mesh under TRAIN_RULES: the embedding is (vocab, fsdp)
    -> Shard(0) on "model", Shard(1) on "data"; norms are replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    model = init_params(get_smoke_config("llama3.2-1b", num_layers=1), device="cpu")
    sh = param_shardings(model, mesh, S.TRAIN_RULES)
    assert sh["embed"].spec == ("model", "data")
    assert sh["embed"].placements == (Shard(1), Shard(0))
    assert sh["ln_f"].placements == (Replicate(), Replicate())
    assert sh["layers.0.attn.wq"].spec == ("data", "model")


def test_tree_shardings_follow_the_tree():
    """A nested tree of logical axes and shapes maps leaf by leaf to
    ``sharding_for``'s; ``spec_for`` needs a mesh and rules or a context."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    specs = {"w": ("fsdp", "mlp"), "blocks": [("batch",), (None, "vocab")]}
    shapes = {"w": (4, 6), "blocks": [(8,), (3, 4)]}
    out = S.tree_shardings(specs, shapes, mesh, S.TRAIN_RULES)
    assert out["w"].spec == ("data", "model")
    assert [b.spec for b in out["blocks"]] == [("data",), (None, "model")]
    assert out["blocks"][1] == S.sharding_for((None, "vocab"), (3, 4), mesh, S.TRAIN_RULES)
    with pytest.raises(ValueError, match="sharding context"):
        S.spec_for(("batch",), (4,))


# ----------------------------------------------------------------------------
# the meshes
# ----------------------------------------------------------------------------

def test_one_process_meshes():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert list(mesh.shape.items()) == [("data", 2), ("model", 2)]
    assert mesh.axis_names == ("data", "model") and not mesh.multi_process
    host = make_host_mesh(device="cpu")
    assert dict(host.shape) == {"data": 1, "model": 1}
    assert dict(make_host_mesh(model=2, devices=["cpu"] * 4).shape) == {"data": 2, "model": 2}
    assert dict(make_mesh((1,), ("data",), device="cpu").shape) == {"data": 1}
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        make_mesh((2,), ("data",), device="cpu")
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="world of"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_data_parallel_runs_slices_in_order():
    """One call of ``fn`` a slice, each on its device's rows in order, the
    outputs concatenated; identity on a mesh without a batch axis."""
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    calls = []

    def fn(params, batch):
        calls.append(batch["x"].clone())
        return batch["x"] * params["w"]

    x = torch.arange(8.0)
    out = S.data_parallel(fn, mesh)({"w": torch.tensor(2.0)}, {"x": x})
    assert torch.equal(out, 2 * x) and [c.tolist() for c in calls] == [
        [0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    model_only = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    assert S.data_parallel(fn, model_only) is fn
    with pytest.raises(ValueError, match="split"):
        S.data_parallel(fn, mesh)({"w": torch.tensor(1.0)}, {"x": torch.arange(6.0)})


def test_multi_process_mesh_groups_and_layout(tmp_path):
    """4 gloo ranks on a (2, 2) ("data", "model") mesh: a data group sums
    over the 2 ranks of a model column; a row split over ("data", "model")
    gives rank (d, m) block d * 2 + m, as ``P(("data", "model"))`` does."""
    code = """
    import json
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import placements_for
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    assert mesh.multi_process and dict(mesh.shape) == {"data": 2, "model": 2}
    c = mesh.coordinate()
    t = torch.tensor([float(RANK)])
    dist.all_reduce(t, group=mesh.group(("data",)))
    w = torch.tensor([1.0])
    dist.all_reduce(w, group=mesh.group(("data", "model")))
    full = torch.arange(8.0).reshape(8, 1)
    d = distribute_tensor(full, mesh.device_mesh, placements_for((("data", "model"),), mesh),
                          src_data_rank=None)
    print(json.dumps({"coord": c, "data_sum": t.item(), "world": w.item(),
                      "index": mesh.index(("data", "model")),
                      "local": d.to_local().reshape(-1).tolist()}))
    """
    outs = [json.loads(o.strip().splitlines()[-1]) for o in run_ranks(code, 4, tmp_path)]
    for rank, o in enumerate(outs):
        d, m = divmod(rank, 2)
        assert o["coord"] == {"data": d, "model": m}
        assert o["data_sum"] == m + (m + 2)          # ranks m and m + 2
        assert o["world"] == 4.0
        assert o["index"] == d * 2 + m
        assert o["local"] == [2.0 * (d * 2 + m), 2.0 * (d * 2 + m) + 1]


# ----------------------------------------------------------------------------
# the MoE dispatch groups
# ----------------------------------------------------------------------------

def _moe(reference):
    cfg = get_smoke_config("olmoe-1b-7b", **MOE_OVER)
    p = MoE(cfg, torch.Generator().manual_seed(0))
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(p, name).copy_(_to_torch(reference["moe"][name]))
    return cfg, p


def _reference_keep(rp, cfg, x):
    """The reference's kept (token, choice) pairs of one group, by its own
    steps (``tests/test_torch_models.py``'s ``_reference_keep``)."""
    e, k, t = cfg.num_experts, cfg.num_experts_per_tok, x.shape[0]
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ rp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = max(int(np.ceil(t * k / e * cfg.moe_capacity_factor)), 1)
    flat_e = top_e.reshape(t * k)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(e_sorted, jnp.arange(e))[e_sorted]
    keep = np.zeros(t * k, bool)
    keep[np.asarray(order)] = np.asarray(pos < cap)
    return keep.reshape(t, k)


def test_moe_groups_keep_the_references_pairs(reference):
    cfg, p = _moe(reference)
    x = torch.from_numpy(reference["moe"]["x"])
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    with S.sharding_context(mesh, S.TRAIN_RULES):
        assert S.num_batch_shards() == 4
        got = moe_mlp(p, cfg, x).numpy()
    one = moe_mlp(p, cfg, x).numpy()
    want, want_one = reference["moe"]["grouped"], reference["moe"]["one"]
    rp = {k: jnp.asarray(reference["moe"][k]) for k in ("router",)}
    groups = x.reshape(4, -1, cfg.d_model)
    kept = [moe_route(p, cfg, g)[2].numpy() for g in groups]
    assert all(moe_capacity(cfg, g.shape[0]) == 6 for g in groups)
    for g, k in zip(groups, kept):
        np.testing.assert_array_equal(k, _reference_keep(rp, cfg, g.numpy()))
    single = moe_route(p, cfg, x.reshape(-1, cfg.d_model))[2].numpy()
    assert (np.concatenate(kept) != single).any(), "the groups dropped the same pairs"
    assert sum((~k).sum() for k in kept) > 0
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-5 * scale
    assert np.abs(one - want_one).max() <= 2e-5 * np.abs(want_one).max()
    assert np.abs(got - one).max() > 1e-3 * scale


def _moe_mlp_single_group(p, cfg, x):
    """``moe_mlp`` as it was before the groups: one dispatch over B * S."""
    b, s, d = x.shape
    e = cfg.num_experts
    xt = x.reshape(b * s, d)
    top_e, top_w, keep, slot = moe_route(p, cfg, xt)
    cap = moe_capacity(cfg, b * s)
    k = top_e.shape[1]
    tok = torch.arange(b * s, device=x.device)[:, None].expand(-1, k)
    buf = x.new_zeros((e * cap, d))
    buf[slot[keep]] = xt[tok[keep]]
    buf = buf.reshape(e, cap, d)
    act = F.silu if cfg.act in ("silu", "geglu") else gelu
    h = act(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_buf = torch.bmm(h, p.w_down).reshape(e * cap, d)
    picked = out_buf[slot.clamp_max(e * cap - 1)]
    contrib = torch.where(keep[..., None], picked, picked.new_zeros(()))
    contrib = contrib * top_w[..., None].to(x.dtype)
    return contrib.sum(dim=1).reshape(b, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_outside_a_context_is_one_group_bit_for_bit(dtype):
    cfg = get_smoke_config("olmoe-1b-7b", dtype=dtype, moe_capacity_factor=1.0)
    p = MoE(cfg, torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 9, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    assert torch.equal(moe_mlp(p, cfg, x), _moe_mlp_single_group(p, cfg, x))
    # a batch the shards do not divide falls back to one group
    with S.sharding_context(make_mesh((3,), ("data",), devices=["cpu"] * 3), S.TRAIN_RULES):
        assert torch.equal(moe_mlp(p, cfg, x), _moe_mlp_single_group(p, cfg, x))
