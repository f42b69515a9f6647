"""The port's sharded train step (``train.make_train_step`` on a model laid
out by ``models.partition.shard_params``, under ``sharding_context(mesh,
TRAIN_RULES)``) on a world of 4 gloo ranks on the CPU, a 2 x 2 ("data",
"model") mesh, against the reference's ``jax.jit(make_train_step(cfg,
ocfg, 2))`` under ``sharding_context(make_mesh((2, 2)), TRAIN_RULES)`` on 4
forced host devices, and against the port's one-process step.

Every family's smoke config runs, at f32, 2 microbatches of a batch of 8
rows: the dense one under remat (its layers gather their FSDP shards again
in the recomputation), the MoE also at the published capacity factor 1.25
(the smoke config's 8 drops nothing; at 1.25 each rank's experts take and
drop the slots of the whole group's routing), and two overrides that are
the layout traps of the
model axis: llama3-8b with 4 query heads and 1 kv head (the query heads
split, each rank reads the one kv head its heads map to) and qwen2-1.5b
with 3 heads (``3 * 16`` columns split ``wq`` in storage, the heads do
not: every head computed on every rank).  Both sides start from the
reference's parameters (``interop.params_from_jax(mesh=)``) and zero
moments (``opt_state_from_jax(mesh=)``).

The rule is the trainer's (``tests/test_torch_manual_dp.py``): lr 1e-2,
``eps = 1`` and no clipping, so Adam's first step is ``lr * g / (|g| +
1)`` elementwise; the loss within 1e-5 relative, ``grad_norm`` within 1e-4
relative, each element's update within 1e-4 of its leaf's largest
|update| (two f32 evaluations whose sums run in other orders).  Against the
port's one-process step the MoE routes in the reference's groups: one per
batch shard of each microbatch (``num_batch_shards`` under a one-process
2 x 2 mesh), and each element's bound adds how far the one-process step's
update lies from the reference's (the triangle inequality through the
reference): the one-process port's RWKV embedding update lies 2x the rule
from the reference's at f32, and the sharded step between the two.

The dense case's trained state is saved by the world (DTensor leaves,
gathered; rank 0 writes), restored in place onto a fresh sharded model and
moments in the world, and restored whole by both packages: bit for bit
each time.  The world runs in ~15 s, the reference's process in ~40 s,
side by side.
"""
import hashlib
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore as jax_restore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.checkpoint.checkpoint import restore
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import TRAIN_RULES, sharding_context
from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

from torch_ranks import finish, run_ranks, run_reference, unflatten_paths

WORLD, LR, MICRO, ROWS, SEQ = 4, 1e-2, 2, 8, 16
OPT = dict(peak_lr=LR, warmup_steps=0, decay_steps=10, eps=1.0, clip_norm=1e6)
CASES = {
    "dense": ("llama3.2-1b", {"remat": True}),
    "moe": ("olmoe-1b-7b", {}),
    "moe_drops": ("olmoe-1b-7b", {"moe_capacity_factor": 1.25}),
    "ssm": ("rwkv6-1.6b", {}),
    "hybrid": ("recurrentgemma-9b", {}),
    "encdec": ("whisper-medium", {}),
    "vlm": ("pixtral-12b", {}),
    "kv_heads_whole": ("llama3-8b", {"num_heads": 4, "num_kv_heads": 1}),
    "heads_whole": ("qwen2-1.5b", {"num_heads": 3, "num_kv_heads": 1}),
}

REFERENCE = """
import hashlib, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.launch.sharding import TRAIN_RULES, sharding_context
from repro.models import init_params
from repro.models.partition import param_shardings
from repro.train import OptimizerConfig, init_opt_state, make_train_step

out, cases, opt = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
mesh = make_mesh((2, 2), ("data", "model"))
res = {}
for name, (arch, over) in cases.items():
    cfg = get_smoke_config(arch, dtype="float32", **over)
    params = init_params(cfg, jax.random.key(0))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    digest = hashlib.sha256(b"".join(np.asarray(l).tobytes() for _, l in leaves)).hexdigest()
    params = jax.device_put(params, param_shardings(params, mesh, TRAIN_RULES))
    batch = {k: jnp.asarray(v) for k, v in np.load(f"{out}/batch_{name}.npz").items()}
    with sharding_context(mesh, TRAIN_RULES):
        step = jax.jit(make_train_step(cfg, OptimizerConfig(**opt), 2))
        new, _, m = step(params, init_opt_state(params), batch)
    flat = jax.tree_util.tree_flatten_with_path(new)[0]
    np.savez(f"{out}/ref_{name}.npz",
             **{"/".join(k.key for k in path): np.asarray(l) for path, l in flat})
    res[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "params_sha256": digest}
print(json.dumps(res))
"""

RANKS = """
import json
import numpy as np
from repro_torch.checkpoint.checkpoint import restore, save
from repro_torch.configs import get_smoke_config
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch.cells import local_shape
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import TRAIN_RULES, sharding_context
from repro_torch.models.partition import param_shardings
from repro_torch.train import OptimizerConfig, make_train_step, sharded


def tree_of(name):
    out = {}
    for path, leaf in np.load(f"{OUT}/init_{name}.npz").items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def zeros(tree):
    return {k: zeros(v) if isinstance(v, dict) else [zeros(x) for x in v]
            if isinstance(v, list) else np.zeros_like(v) for k, v in tree.items()}


def fresh(cfg, name):
    tree = tree_of(name)
    params = params_from_jax(cfg, tree, mesh=mesh, rules=TRAIN_RULES)
    state = opt_state_from_jax(cfg, {"m": zeros(tree), "v": zeros(tree),
                                     "step": np.int32(0)}, mesh=mesh, rules=TRAIN_RULES)
    return params, state


mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
res = {}
for name, (arch, over) in CASES.items():
    cfg = get_smoke_config(arch, dtype="float32", **over)
    params, state = fresh(cfg, name)
    held = sum(sharded.local(p).numel() * p.element_size() for p in params.parameters())
    want = sum(np.prod(local_shape(tuple(params.get_parameter(k).shape), sh)) * 4
               for k, sh in param_shardings(params, mesh, TRAIN_RULES).items())
    batch = {k: torch.from_numpy(v) for k, v in np.load(f"{OUT}/batch_{name}.npz").items()}
    with sharding_context(mesh, TRAIN_RULES):
        layer = next(iter(params.stack()))
        attn = getattr(layer, "attn", None)
        plan = None if attn is None else sharded.attention(attn, cfg)
        params, state, m = make_train_step(cfg, OptimizerConfig(**OPT), MICRO)(
            params, state, batch)
    full = {k: p.full_tensor().detach() for k, p in params.named_parameters()}
    res[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "step": int(state["step"]), "held": held, "want": int(want),
                 "types": sorted({type(t).__name__ for t in state["m"].values()}),
                 "attention": None if plan is None else [plan[1].n, plan[2]]}
    if RANK == 0:
        torch.save(full, f"{OUT}/port_{name}.pt")
    if name == "dense":
        save(f"{OUT}/ckpt", 1, {"params": params, "opt": state})
        again, again_state = fresh(cfg, name)
        tree, manifest = restore(f"{OUT}/ckpt", 1, {"params": again, "opt": again_state})
        same = all(torch.equal(sharded.local(a), sharded.local(b))
                   for a, b in zip(params.parameters(), again.parameters()))
        same &= all(torch.equal(sharded.local(state[key][k]), sharded.local(tree["opt"][key][k]))
                    for key in ("m", "v") for k in state[key])
        res[name]["restored_in_place"] = bool(same and tree["params"] is again)
        res[name]["restored_step"] = int(tree["opt"]["step"])
print(json.dumps(res))
"""


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((ROWS, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.num_patches:
        out["patches"] = rng.standard_normal((ROWS, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return out


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world, the reference's process and the one-process steps, once
    for the module; the world and the reference side by side."""
    out = tmp_path_factory.mktemp("sharded_step")
    init, digests = {}, {}
    for i, (name, (arch, over)) in enumerate(CASES.items()):
        rcfg = jax_smoke_config(arch, dtype="float32", **over)
        rparams = jax.tree.map(np.asarray, jax_init_params(rcfg, jax.random.key(0)))
        leaves = jax.tree_util.tree_flatten_with_path(rparams)[0]
        digests[name] = hashlib.sha256(b"".join(l.tobytes() for _, l in leaves)).hexdigest()
        init[name] = rparams
        np.savez(out / f"init_{name}.npz", **dict(_flat_paths(rparams)))
        np.savez(out / f"batch_{name}.npz", **_batch(rcfg, i))
    ref = run_reference(REFERENCE, WORLD, args=[str(out), json.dumps(CASES), json.dumps(OPT)])
    code = RANKS.replace("CASES.items()", f"{CASES!r}.items()").replace(
        "OptimizerConfig(**OPT)", f"OptimizerConfig(**{OPT!r})").replace(
        "MICRO)", f"{MICRO})")
    ranks = [json.loads(o.strip().splitlines()[-1])
             for o in run_ranks(code, WORLD, out, timeout=240)]
    # the port on one process, the MoE routed in the reference's groups
    host = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * WORLD)
    one, before = {}, {}
    for name, (arch, over) in CASES.items():
        cfg = get_smoke_config(arch, dtype="float32", **over)
        params = params_from_jax(cfg, init[name], device="cpu")
        before[name] = {k: p.detach().clone() for k, p in params.named_parameters()}
        batch = {k: torch.from_numpy(v) for k, v in np.load(out / f"batch_{name}.npz").items()}
        with sharding_context(host, TRAIN_RULES):
            params, _, m = make_train_step(cfg, OptimizerConfig(**OPT), MICRO)(
                params, init_opt_state(params), batch)
        one[name] = ({k: p.detach().clone() for k, p in params.named_parameters()},
                     float(m["loss"]), float(m["grad_norm"]))
    reference = json.loads(finish(ref).strip().splitlines()[-1])
    ref_new = {}
    for name, (arch, over) in CASES.items():
        assert reference[name]["params_sha256"] == digests[name], name
        cfg = get_smoke_config(arch, dtype="float32", **over)
        tree = unflatten_paths(dict(np.load(out / f"ref_{name}.npz")))
        ref_new[name] = {k: p.detach() for k, p in
                         params_from_jax(cfg, tree, device="cpu").named_parameters()}
    port = {name: torch.load(out / f"port_{name}.pt") for name in CASES}
    return {"out": out, "ranks": ranks, "one": one, "before": before, "port": port,
            "reference": reference, "ref_new": ref_new}


def _hold(before, got, want, what, slack=None):
    """Each element's update within 1e-4 of the leaf's largest |update|,
    plus ``slack`` (a tree of per-element bounds) where given."""
    assert set(got) == set(want) == set(before)
    for k, b in before.items():
        du, dw = got[k].float() - b, want[k].float() - b
        tol = 1e-4 * float(dw.abs().max()) + (0.0 if slack is None else slack[k])
        bad = (du - dw).abs() > tol
        assert not bad.any(), (what, k, float((du - dw).abs().max()), int(bad.sum()))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_one_process_step(runs, name):
    ranks = runs["ranks"]
    got, (want, loss, gnorm) = runs["port"][name], runs["one"][name]
    assert len({json.dumps(r[name]["loss"]) for r in ranks}) == 1
    assert all(r[name]["step"] == 1 for r in ranks)
    np.testing.assert_allclose(ranks[0][name]["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(ranks[0][name]["grad_norm"], gnorm, rtol=1e-4)
    ref = runs["ref_new"][name]
    apart = {k: (want[k].float() - ref[k].float()).abs() for k in want}
    _hold(runs["before"][name], got, want, f"{name} against one process", apart)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_reference(runs, name):
    ref = runs["reference"][name]
    rank = runs["ranks"][0][name]
    np.testing.assert_allclose(rank["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(rank["grad_norm"], ref["grad_norm"], rtol=1e-4)
    _hold(runs["before"][name], runs["port"][name], runs["ref_new"][name],
          f"{name} against the reference")


def test_ranks_hold_their_blocks(runs):
    """Each rank holds exactly its blocks of the parameters in the
    reference's layout, and its moments are DTensors."""
    for r in runs["ranks"]:
        for name in CASES:
            assert r[name]["held"] == r[name]["want"] > 0, name
            assert r[name]["types"] == ["DTensor"], name


def test_layout_traps_take_their_compute_paths(runs):
    """Attention's plan on the 2-way model axis, (ranks it splits over, kv
    head read whole): llama3-8b's 4 query heads split and each rank reads
    kv head 0 of 1; qwen2's 3 heads are computed whole; llama3.2-1b's 4
    query and 4 kv heads split."""
    plans = [r for r in runs["ranks"]]
    for r in plans:
        assert r["kv_heads_whole"]["attention"] == [2, 0]
        assert r["heads_whole"]["attention"] == [1, None]
        assert r["dense"]["attention"] == [2, None]


def test_sharded_checkpoint_restores_in_both_packages(runs):
    """The world's checkpoint: in place onto sharded state in the world, and
    whole in the port and in the reference, bit for bit."""
    for r in runs["ranks"]:
        assert r["dense"]["restored_in_place"] and r["dense"]["restored_step"] == 1
    root = str(runs["out"] / "ckpt")
    trained = runs["port"]["dense"]
    target = {"params": {k: torch.zeros_like(t) for k, t in trained.items()},
              "opt": {"m": {k: torch.zeros_like(t) for k, t in trained.items()},
                      "v": {k: torch.zeros_like(t) for k, t in trained.items()},
                      "step": torch.tensor(0, dtype=torch.int32)}}
    ours, manifest = restore(root, 1, target)
    assert manifest["step"] == 1 and int(ours["opt"]["step"]) == 1
    jax_target = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), target)
    jax_target["opt"]["step"] = np.int32(0)
    theirs, _ = jax_restore(root, 1, jax_target)
    for k, t in trained.items():
        assert torch.equal(ours["params"][k], t), k
        np.testing.assert_array_equal(np.asarray(theirs["params"][k]), t.numpy())
        np.testing.assert_array_equal(np.asarray(theirs["opt"]["m"][k]),
                                      ours["opt"]["m"][k].numpy())


def test_remat_recomputes_in_the_forwards_context(tmp_path):
    """On a card the autograd engine runs the backward, and so a remat
    layer's recomputation, on a thread of its own, where the caller's
    sharding context is not active: the recomputation enters the forward's
    context.  A sharded model's backward run on another thread gives the
    gradients of one run on the caller's (a world of one rank)."""
    code = """
    import threading
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import TRAIN_RULES, sharding_context
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.partition import shard_params
    from repro_torch.train import sharded

    cfg = get_smoke_config("llama3.2-1b", dtype="float32", remat=True)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    params = shard_params(init_params(cfg, device="cpu"), mesh, TRAIN_RULES)
    leaves = [sharded.local(p).requires_grad_() for p in params.parameters()]
    batch = {"tokens": torch.arange(32).reshape(2, 16) % cfg.vocab_size}
    out = {}

    def grads(key):
        out[key] = torch.autograd.grad(out["loss"], leaves, retain_graph=True)

    with sharding_context(mesh, TRAIN_RULES):
        out["loss"] = loss_fn(cfg, params, batch)
        grads("here")
    worker = threading.Thread(target=grads, args=("there",))
    worker.start()
    worker.join()
    assert all(torch.equal(a, b) for a, b in zip(out["here"], out["there"]))
    print("OK")
    """
    assert "OK" in run_ranks(code, 1, tmp_path)[0]
