"""The port's sharded prefill and decode (``models.forward`` under
``SERVE_RULES``, ``models.decode_step`` under ``DECODE_RULES``, on a model
laid out by ``models.partition.shard_params`` and a cache laid out by
``shard_cache``) on a world of 4 gloo ranks on the CPU, a 2 x 2 ("data",
"model") mesh, against the reference's ``jax.jit(forward)`` /
``jax.jit(decode_step)`` under ``sharding_context(make_mesh((2, 2)),
SERVE_RULES / DECODE_RULES)`` on 4 forced host devices (the parameters
placed by ``param_shardings``, the cache by the reference's
``_cache_logical_axes``), and against the port's one-process forward and
decode.

Every family's smoke config runs at f32, and so do the two layout traps
of the model axis (``tests/test_torch_sharded_step.py``): llama3-8b with 4
query heads and 1 kv head, qwen2-1.5b with 3 heads.  A batch of 4 rows
(2 a data rank): the prefill over 8 tokens, then 12 decode steps from a
seeded non-zero cache of 16 slots (8 a model rank), so every family's
steps cross the slots' shard boundary: the K/V rows, the hybrid's ring of
16, whisper's 64 padded frames (32 real: the second model rank's frames
are all masked).  The steps run from position 0 for the whole batch, and
per slot (rows starting at 0, 4, 2, 3) where ``has_positional_cache``.

Logits (the ranks' rows and vocabulary columns gathered) and the final
cache (gathered with ``train.sharded.whole_tree``) agree within 2e-5 of
their largest |value| with the reference's and with the one-process
port's (the MoE routed in the reference's groups: one per batch shard,
under a one-process 2 x 2 mesh).  The world runs in ~10 s, the
reference's process in ~35 s, side by side.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.cells import _cache_logical_axes as ref_cache_axes
from repro.launch.sharding import DECODE_RULES as REF_DECODE
from repro.launch.sharding import SERVE_RULES as REF_SERVE
from repro.launch.sharding import spec_for as ref_spec_for
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.interop import _unflatten, cache_from_jax, params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import DECODE_RULES, SERVE_RULES, sharding_context
from repro_torch.models import decode_step, forward, init_cache

from torch_ranks import finish, run_ranks, run_reference, unflatten_paths

WORLD, ROWS, SEQ, SLOTS, STEPS = 4, 4, 8, 16, 12
STARTS = [0, 4, 2, 3]  # per-slot positions: row r decodes STARTS[r] + step
CASES = {
    "dense": ("llama3.2-1b", {}),
    "moe": ("olmoe-1b-7b", {}),
    "ssm": ("rwkv6-1.6b", {}),
    "hybrid": ("recurrentgemma-9b", {}),
    "encdec": ("whisper-medium", {}),
    "vlm": ("pixtral-12b", {}),
    "kv_heads_whole": ("llama3-8b", {"num_heads": 4, "num_kv_heads": 1}),
    "heads_whole": ("qwen2-1.5b", {"num_heads": 3, "num_kv_heads": 1}),
}
PER_SLOT = [n for n, (a, o) in CASES.items()
            if get_smoke_config(a, **o).has_positional_cache]

REFERENCE = """
import functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.cells import _cache_logical_axes
from repro.launch.mesh import make_mesh
from repro.launch.sharding import DECODE_RULES, SERVE_RULES, sharding_context, sharding_for
from repro.models import decode_step, forward, init_cache, init_params
from repro.models.partition import param_shardings

out, cases, dims = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
rows, slots, steps, starts = dims["rows"], dims["slots"], dims["steps"], dims["starts"]
mesh = make_mesh((2, 2), ("data", "model"))


def name_of(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def flat(tree):
    return {name_of(p): np.asarray(l) for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def placed(cache):
    sh = jax.tree.map(lambda l, a: sharding_for(a, l.shape, mesh, DECODE_RULES), cache,
                      _cache_logical_axes(cache))
    return jax.device_put(cache, sh)


def load(like, path):
    # ``like``'s tree with the leaves saved at ``path`` by dotted name
    saved = dict(np.load(path))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(saved[name_of(p)])
                                                  for p, _ in leaves])


for name, (arch, over) in cases.items():
    cfg = get_smoke_config(arch, dtype="float32", **over)
    params = load(jax.eval_shape(lambda: init_params(cfg, jax.random.key(0))),
                  f"{out}/init_{name}.npz")
    batch = {k: jnp.asarray(v) for k, v in np.load(f"{out}/batch_{name}.npz").items()}
    cache0 = load(init_cache(cfg, rows, slots), f"{out}/cache_{name}.npz")
    tokens = np.load(f"{out}/tokens_{name}.npy")
    res = {}
    with sharding_context(mesh, SERVE_RULES):
        p = jax.device_put(params, param_shardings(params, mesh, SERVE_RULES))
        res["prefill"] = np.asarray(jax.jit(lambda p, b: forward(cfg, p, b))(p, batch))
    runs = {"scalar": [jnp.int32(i) for i in range(steps)]}
    if cfg.has_positional_cache:
        runs["per_slot"] = [jnp.asarray(starts, jnp.int32) + i for i in range(steps)]
    for run, positions in runs.items():
        with sharding_context(mesh, DECODE_RULES):
            p = jax.device_put(params, param_shardings(params, mesh, DECODE_RULES))
            step = jax.jit(functools.partial(decode_step, cfg))
            cache, logits = placed(cache0), []
            for i, pos in enumerate(positions):
                lg, cache = step(p, cache, jnp.asarray(tokens[i]), pos)
                logits.append(np.asarray(lg))
        res[f"{run}_logits"] = np.stack(logits)
        res.update({f"{run}_cache/{k}": v for k, v in flat(cache).items()})
    np.savez(f"{out}/ref_{name}.npz", **res)
print(json.dumps(sorted(cases)))
"""

RANKS = """
import json
import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.interop import _unflatten, cache_from_jax, params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import DECODE_RULES, SERVE_RULES, sharding_context
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.train import sharded

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
at = mesh.coordinate()
data, model = mesh.group(("data",)), mesh.group(("model",))


def tree_of(path):
    out = {}
    for key, leaf in np.load(path).items():
        node = out
        *head, last = key.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def mine(x):
    # the rank's rows of a global batch leaf
    n = x.shape[0] // mesh.shape["data"]
    return x[at["data"] * n:(at["data"] + 1) * n]


def gathered(logits, vocab_split):
    if vocab_split:
        logits = sharded.gather_dim(logits, logits.ndim - 1, model, mesh.shape["model"])
    return sharded.gather_dim(logits, 0, data, mesh.shape["data"])


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def seeded(cfg, name):
    like = init_cache(cfg, DIMS["rows"], DIMS["slots"], "meta")
    return _unflatten(like, dict(np.load(f"{OUT}/cache_{name}.npz")))


res, saved = {}, {}
for name, (arch, over) in CASES.items():
    cfg = get_smoke_config(arch, dtype="float32", **over)
    tree = tree_of(f"{OUT}/init_{name}.npz")
    batch = {k: torch.from_numpy(mine(v)) for k, v in np.load(f"{OUT}/batch_{name}.npz").items()}
    tokens = np.load(f"{OUT}/tokens_{name}.npy")
    params = params_from_jax(cfg, tree, mesh=mesh, rules=SERVE_RULES)
    with sharding_context(mesh, SERVE_RULES):
        split = sharded.top(params)[1].n > 1
        logits = forward(cfg, params, batch)
        again, fresh = prefill(cfg, params, batch, DIMS["slots"])
    saved[f"{name}/prefill"] = gathered(logits, split)
    rec = {"prefill_again": bool(torch.equal(logits, again)),
           "prefill_cache": {k: [list(t.shape), [list(a) if isinstance(a, tuple) else a
                                                  for a in sharded.spec_of(t)]]
                             for k, t in flat(fresh).items()}}
    params = params_from_jax(cfg, tree, mesh=mesh, rules=DECODE_RULES)
    runs = {"scalar": [i for i in range(DIMS["steps"])]}
    if cfg.has_positional_cache:
        runs["per_slot"] = [torch.tensor(mine(np.array(DIMS["starts"])) + i)
                            for i in range(DIMS["steps"])]
    for run, positions in runs.items():
        cache = cache_from_jax(cfg, seeded(cfg, name), mesh=mesh, rules=DECODE_RULES)
        held = {k: [list(sharded.local(t).shape), [list(a) if isinstance(a, tuple) else a
                                                   for a in sharded.spec_of(t)]]
                for k, t in flat(cache).items()}
        logits = []
        with sharding_context(mesh, DECODE_RULES):
            for i, pos in enumerate(positions):
                lg, cache = decode_step(cfg, params, cache, torch.from_numpy(mine(tokens[i])),
                                        pos)
                logits.append(gathered(lg, split))
        saved[f"{name}/{run}_logits"] = torch.stack(logits)
        for k, t in flat(sharded.whole_tree(cache)).items():
            saved[f"{name}/{run}_cache/{k}"] = t
        rec[f"{run}_layout"] = held
    res[name] = rec
if RANK == 0:
    np.savez(f"{OUT}/port.npz", **{k: v.numpy() for k, v in saved.items()})
print(json.dumps(res))
"""


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _dotted(tree):
    return {path.replace("/", "."): leaf for path, leaf in _flat_paths(tree)}


def _named(like, draw):
    """{dotted path: ``draw(leaf)``} over a reference tree of shapes."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): draw(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(like)[0]}


def _inputs(rcfg, seed):
    """From one seed: parameters of the reference's tree (normal draws at
    its matrices' 1/sqrt(fan-in) scale, and non-zero norms, biases and
    gates), the prefill's batch, a cache of the reference's tree and the
    decode's tokens; the trees as {dotted path: array}."""
    rng = np.random.default_rng(seed)

    def weight(leaf):
        scale = leaf.shape[-2] ** -0.5 if len(leaf.shape) >= 2 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    params = _named(jax.eval_shape(lambda: jax_init_params(rcfg, jax.random.key(0))), weight)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (ROWS, SEQ)).astype(np.int32)}
    if rcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (ROWS, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    if rcfg.num_patches:
        batch["patches"] = rng.standard_normal(
            (ROWS, rcfg.num_patches, rcfg.d_model)).astype(np.float32)
    cache = _named(jax.eval_shape(lambda: jax_init_cache(rcfg, ROWS, SLOTS)),
                   lambda leaf: (0.5 * rng.standard_normal(leaf.shape)).astype(leaf.dtype))
    tokens = rng.integers(0, rcfg.vocab_size, (STEPS, ROWS, 1)).astype(np.int32)
    return params, batch, cache, tokens


def _tree(cfg, flat_cache):
    """The port's cache tree (``init_cache``'s structure) of dotted leaves."""
    return _unflatten(init_cache(cfg, ROWS, SLOTS, "meta"), flat_cache)


def _one_process(cfg, params, batch, cache, tokens):
    """The port's forward and decode in this process, the MoE routed in the
    reference's groups (a one-process 2 x 2 mesh: 2 batch shards)."""
    host = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * WORLD)
    params = params_from_jax(cfg, unflatten_paths(params, "."), device="cpu")
    out = {}
    with sharding_context(host, SERVE_RULES):
        out["prefill"] = forward(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    runs = {"scalar": list(range(STEPS))}
    if cfg.has_positional_cache:
        runs["per_slot"] = [torch.tensor(STARTS) + i for i in range(STEPS)]
    for run, positions in runs.items():
        c = cache_from_jax(cfg, _tree(cfg, cache), device="cpu")
        logits = []
        with sharding_context(host, DECODE_RULES):
            for i, pos in enumerate(positions):
                lg, c = decode_step(cfg, params, c, torch.from_numpy(tokens[i]), pos)
                logits.append(lg)
        out[f"{run}_logits"] = torch.stack(logits)
        out.update({f"{run}_cache/{k}": v for k, v in _dotted(c).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world, the reference's two processes (half the cases each) and
    the one-process port, once for the module; the world and the
    reference side by side."""
    out = tmp_path_factory.mktemp("sharded_decode")
    inputs = {}
    for i, (name, (arch, over)) in enumerate(CASES.items()):
        rcfg = jax_smoke_config(arch, dtype="float32", **over)
        params, batch, cache, tokens = inputs[name] = _inputs(rcfg, i)
        np.savez(out / f"init_{name}.npz", **params)
        np.savez(out / f"batch_{name}.npz", **batch)
        np.savez(out / f"cache_{name}.npz", **cache)
        np.save(out / f"tokens_{name}.npy", tokens)
    dims = {"rows": ROWS, "slots": SLOTS, "steps": STEPS, "starts": STARTS}
    names = list(CASES)
    halves = [{n: CASES[n] for n in names[i::2]} for i in range(2)]
    refs = [run_reference(REFERENCE, WORLD, args=[str(out), json.dumps(h), json.dumps(dims)])
            for h in halves]
    code = RANKS.replace("CASES.items()", f"{CASES!r}.items()").replace(
        "DIMS[", f"{dims!r}[")
    ranks = [json.loads(o.strip().splitlines()[-1])
             for o in run_ranks(code, WORLD, out, timeout=240)]
    one = {}
    for name, (arch, over) in CASES.items():
        cfg = get_smoke_config(arch, dtype="float32", **over)
        one[name] = _one_process(cfg, *inputs[name])
    for ref, half in zip(refs, halves):
        assert json.loads(finish(ref).strip().splitlines()[-1]) == sorted(half)
    reference = {name: dict(np.load(out / f"ref_{name}.npz")) for name in CASES}
    port = dict(np.load(out / "port.npz"))
    world = {name: {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in port.items()
                    if k.split("/", 1)[0] == name} for name in CASES}
    return {"ranks": ranks, "world": world, "one": one, "reference": reference}


def _close(got, want, what):
    """Within 2e-5 of the largest |value| (the port's f32 forward rule)."""
    want = torch.as_tensor(np.asarray(want)).float()
    got = torch.as_tensor(got).float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 2e-5 * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, (what, err, tol)


def _runs(name):
    return ["scalar", "per_slot"] if name in PER_SLOT else ["scalar"]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_matches_the_reference(runs, name):
    _close(runs["world"][name]["prefill"], runs["reference"][name]["prefill"],
           f"{name} prefill")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_the_reference(runs, name):
    """Each of the 12 steps' logits and the final cache, leaf by leaf, from
    position 0 for the whole batch."""
    world, ref = runs["world"][name], runs["reference"][name]
    for i in range(STEPS):
        _close(world["scalar_logits"][i], ref["scalar_logits"][i], f"{name} step {i}")
    leaves = {k for k in ref if k.startswith("scalar_cache/")}
    assert leaves == {k for k in world if k.startswith("scalar_cache/")}
    for k in leaves:
        _close(world[k], ref[k], f"{name} {k}")


@pytest.mark.parametrize("name", PER_SLOT)
def test_sharded_per_slot_decode_matches_the_reference(runs, name):
    """Per-slot positions (rows at 0, 4, 2, 3 + step): each row's K/V go to
    the model rank that owns its slot, which moves across the boundary at
    a different step for each row."""
    world, ref = runs["world"][name], runs["reference"][name]
    for i in range(STEPS):
        _close(world["per_slot_logits"][i], ref["per_slot_logits"][i], f"{name} step {i}")
    for k in (k for k in ref if k.startswith("per_slot_cache/")):
        _close(world[k], ref[k], f"{name} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_the_one_process_port(runs, name):
    world, one = runs["world"][name], runs["one"][name]
    _close(world["prefill"], one["prefill"], f"{name} prefill")
    for run in _runs(name):
        for i in range(STEPS):
            _close(world[f"{run}_logits"][i], one[f"{run}_logits"][i], f"{name} {run} {i}")
        for k in (k for k in one if k.startswith(f"{run}_cache/")):
            _close(world[k], one[k], f"{name} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_holds_the_references_layout(runs, name):
    """Every rank's cache block: the spec of each leaf is the reference's
    ``spec_for`` of its ``_cache_logical_axes`` under DECODE_RULES (the
    slots over "model", so the kv heads stay whole), and the block is the
    global shape cut by it.  ``prefill``'s fresh cache, at the global batch,
    is laid out under SERVE_RULES (its slots whole, its kv heads split)."""
    arch, over = CASES[name]
    rcfg = jax_smoke_config(arch, dtype="float32", **over)
    decode, serve = (_reference_layout(rcfg, rules) for rules in (REF_DECODE, REF_SERVE))
    for r in runs["ranks"]:
        for run in _runs(name):
            assert r[name][f"{run}_layout"] == {k: [b, s] for k, (g, b, s) in decode.items()}
        assert r[name]["prefill_cache"] == {k: [g, s] for k, (g, b, s) in serve.items()}
        assert r[name]["prefill_again"]
    if name == "encdec":
        assert decode["xk"][2] == [None, "data", "model", None, None]


def _reference_layout(rcfg, rules):
    """{dotted leaf: [global shape, a rank's block, spec]} of the
    reference's cache on the 2 x 2 mesh under ``rules``."""
    like = jax.eval_shape(lambda: jax_init_cache(rcfg, ROWS, SLOTS))
    mesh = type("M", (), {"shape": {"data": 2, "model": 2}})()
    axes = jax.tree_util.tree_leaves(ref_cache_axes(like), is_leaf=lambda x: isinstance(x, tuple))
    out = {}
    for (path, leaf), ax in zip(jax.tree_util.tree_flatten_with_path(like)[0], axes):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = tuple(ref_spec_for(ax, leaf.shape, rules, mesh))
        block = [n // (2 if s else 1) for n, s in zip(leaf.shape, spec)]
        out[key] = [list(leaf.shape), block,
                    [list(s) if isinstance(s, tuple) else s for s in spec]]
    return out
