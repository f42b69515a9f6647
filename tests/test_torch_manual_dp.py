"""The port's data-parallel train step with a compressed all-reduce
(``repro_torch.train.manual_dp``) on a world of 4 gloo ranks on the CPU,
against the port's one-process ``make_train_step`` on the whole batch and
against the reference's ``make_manual_dp_train_step`` on 4 forced host
devices (``tests/test_manual_dp.py``'s configuration: ``llama3.2-1b`` at 2
layers, f32, batch (8, 16)), in the modes none, bf16 and int8.

Both sides start from the reference's parameters and optimizer state
(``interop.params_from_jax`` / ``opt_state_from_jax``).  The step runs at
lr 1e-2, ``eps = 1`` and no clipping (``clip_norm`` 1e6): Adam's first
step is then ``lr * g / (|g| + 1)`` elementwise, a function of each
element's own gradient with slope at most ``lr``, so a bound on a
gradient's error carries over to the update.  Tolerances on the update
``p_new - p_old``, per element, with ``g_r`` rank r's gradient (the port's
``loss_and_grads`` on its slice, computed here) and n = 4:

* every mode: 1e-4 of the leaf's largest |update|, the trainer's rule
  (``tests/test_torch_train.py``: two f32 evaluations whose sums run in
  other orders);
* bf16, against the uncompressed step: ``lr * 2**-8 * sum_r |g_r|`` more
  (bf16's unit roundoff is 2**-8: each g_r is rounded to bf16, and each of
  the n - 1 bf16 additions rounds a partial sum of at most sum_r |g_r|, so
  the sum is off by at most n of those, the mean by one); against the
  reference, twice that (both sides round, maybe in other orders);
* int8, against the uncompressed step: ``lr * scale / 2`` more, with
  ``scale = max_r max|g_r| / 127`` the shared per-leaf scale (each of the n
  rounded terms is off by at most half a quantum; the mean divides by n);
  against the reference, ``lr * scale``: one quantum, since a term whose
  f32 value lies near a rounding tie may round either way between the two
  frameworks on each of the n ranks.  A scale is shared by the slices of
  one leaf of the reference's tree, which stacks a parameter over the
  layers (``layers.0.attn.wq`` and ``layers.1.attn.wq`` share one).

The loss is the mean over ranks of each slice's mean: within f32 rounding
(1e-5 relative) of the whole batch's; against the reference within the
reference's own 2e-2.  The int8 mode's SUM all-reduces receive int32
tensors: each rank records the type of every tensor ``all_reduce`` is
handed.  The whole world runs in ~10 s, the reference's process in ~30 s,
side by side.
"""
import hashlib
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.train import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_smoke_config
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import OptimizerConfig, loss_and_grads, make_train_step
from repro_torch.train.manual_dp import make_manual_dp_train_step

from torch_ranks import finish, run_ranks, run_reference, unflatten_paths

MODES = ("none", "bf16", "int8")
WORLD, LR = 4, 1e-2
OPT = dict(peak_lr=LR, warmup_steps=0, decay_steps=10, eps=1.0, clip_norm=1e6)
OVER = dict(remat=False, num_layers=2, dtype="float32")

REFERENCE = """
import hashlib, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.configs import get_smoke_config
from repro.models import init_params
from repro.train import OptimizerConfig, init_opt_state
from repro.train.manual_dp import make_manual_dp_train_step

out = sys.argv[1]
mesh = make_mesh((4,), ("data",))
cfg = get_smoke_config("llama3.2-1b", remat=False, num_layers=2, dtype="float32")
params = init_params(cfg, jax.random.key(0))
leaves = jax.tree_util.tree_flatten_with_path(params)[0]
digest = hashlib.sha256(b"".join(np.asarray(l).tobytes() for _, l in leaves)).hexdigest()
batch = {"tokens": jnp.asarray(np.load(out + "/tokens.npy"))}
res = {"params_sha256": digest}
for mode in ("none", "bf16", "int8"):
    ocfg = OptimizerConfig(grad_compression=mode, **json.loads(sys.argv[2]))
    new, _, m = make_manual_dp_train_step(cfg, mesh, ocfg)(params, init_opt_state(params), batch)
    flat = jax.tree_util.tree_flatten_with_path(new)[0]
    np.savez(f"{out}/ref_{mode}.npz",
             **{"/".join(k.key for k in path): np.asarray(l) for path, l in flat})
    res[mode] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
print(json.dumps(res))
"""

RANKS = """
import hashlib, json
import numpy as np
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.train import OptimizerConfig
from repro_torch.train.manual_dp import make_manual_dp_train_step

seen = []
reduce = dist.all_reduce


def recording(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
    seen.append({"op": str(op).rsplit(".", 1)[-1], "dtype": str(t.dtype), "n": t.numel()})
    return reduce(t, op=op, group=group, async_op=async_op)


dist.all_reduce = recording
mesh = make_mesh((4,), ("data",), device="cpu")
cfg = get_smoke_config("llama3.2-1b", **json.loads(OVER))
init = torch.load(OUT + "/init.pt")
batch = {"tokens": np.load(OUT + "/tokens.npy")}
res = {}
for mode in ("none", "bf16", "int8"):
    params = Model(cfg, torch.Generator().manual_seed(0))
    params.load_state_dict(init["params"])
    state = {"m": {k: t.clone() for k, t in init["m"].items()},
             "v": {k: t.clone() for k, t in init["v"].items()}, "step": init["step"].clone()}
    step = make_manual_dp_train_step(cfg, mesh, OptimizerConfig(grad_compression=mode,
                                                                **json.loads(OPT)))
    seen.clear()
    params, state, m = step(params, state, batch)
    sd = {k: t.detach().clone() for k, t in params.state_dict().items()}
    if RANK == 0:
        torch.save(sd, f"{OUT}/port_{mode}.pt")
    res[mode] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "wire": step.wire, "seen": list(seen), "step": int(state["step"]),
                 "sha256": hashlib.sha256(b"".join(t.numpy().tobytes()
                                                   for t in sd.values())).hexdigest()}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds run once for the module, side by side."""
    out = tmp_path_factory.mktemp("manual_dp")
    rcfg = jax_smoke_config("llama3.2-1b", **OVER)
    rparams = jax.tree.map(np.asarray, jax_init_params(rcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, rcfg.vocab_size, (8, 16)).astype(np.int32)
    np.save(out / "tokens.npy", tokens)
    ref = run_reference(REFERENCE, WORLD, args=[str(out), json.dumps(OPT)])
    cfg = get_smoke_config("llama3.2-1b", **OVER)
    params = params_from_jax(cfg, rparams, device="cpu")
    state = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jax_init_opt_state(rparams)),
                               device="cpu")
    torch.save({"params": params.state_dict(), **state}, out / "init.pt")
    code = RANKS.replace("json.loads(OVER)", repr(OVER)).replace("json.loads(OPT)", repr(OPT))
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in run_ranks(code, WORLD, out)]
    # the port on one process: the whole batch's step, and each rank's gradients
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    rows = tokens.shape[0] // WORLD
    slices = [loss_and_grads(cfg, params, {"tokens": tokens[r * rows:(r + 1) * rows]})[1]
              for r in range(WORLD)]
    one, _, one_m = make_train_step(cfg, OptimizerConfig(**OPT))(
        params, state, {"tokens": tokens})
    reference = json.loads(finish(ref).strip().splitlines()[-1])
    digest = hashlib.sha256(b"".join(
        leaf.tobytes() for _, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0])).hexdigest()
    assert reference["params_sha256"] == digest, "the reference's process drew other parameters"
    ref_new = {mode: dict(params_from_jax(
        cfg, unflatten_paths(dict(np.load(out / f"ref_{mode}.npz"))), device="cpu"
    ).named_parameters()) for mode in MODES}
    return {"cfg": cfg, "before": before, "n_ref_leaves": len(jax.tree.leaves(rparams)),
            "slices": slices, "ranks": ranks,
            "one": {k: p.detach().clone() for k, p in one.named_parameters()},
            "one_loss": float(one_m["loss"]), "one_grad_norm": float(one_m["grad_norm"]),
            "port": {mode: torch.load(out / f"port_{mode}.pt") for mode in MODES},
            "reference": reference, "ref_new": ref_new}


def _stacked(name: str) -> str:
    """The reference tree's leaf a port parameter is a slice of."""
    return re.sub(r"^(layers|enc|blocks)\.\d+\.", r"\1.", name)


def _compression_bound(runs, name: str, mode: str) -> torch.Tensor:
    """The per-element bound on a reduced gradient's compression error
    (module docstring), against the uncompressed sum."""
    gs = [s[name].float() for s in runs["slices"]]
    if mode == "bf16":
        return 1.01 * 2.0**-8 * sum(g.abs() for g in gs)
    if mode == "int8":
        leaf = _stacked(name)
        scale = max(float(s[k].abs().max()) for s in runs["slices"] for k in s
                    if _stacked(k) == leaf) / 127.0
        return torch.full_like(gs[0], 0.5 * scale * 1.01)
    return torch.zeros_like(gs[0])


def _hold_updates(runs, got: dict, want: dict, extra: float, what: str):
    """Each element's update within 1e-4 of the leaf's largest |update| plus
    ``extra`` times lr times the mode's compression bound."""
    for name, before in runs["before"].items():
        du, dw = got[name].float() - before, want[name].float() - before
        tol = 1e-4 * float(dw.abs().max()) + extra * LR * runs["bound"][name]
        bad = (du - dw).abs() > tol
        assert not bad.any(), (what, name, float((du - dw).abs().max()), int(bad.sum()))


@pytest.fixture(params=MODES)
def mode(request, runs):
    runs["bound"] = {k: _compression_bound(runs, k, request.param) for k in runs["before"]}
    return request.param


def test_dp_step_matches_the_one_process_step(runs, mode):
    """4 ranks against the uncompressed one-process step on the whole batch:
    the loss within f32 rounding, the update within the trainer's rule and
    the mode's compression bound; every rank holds the same parameters."""
    ranks = runs["ranks"]
    assert len({r[mode]["sha256"] for r in ranks}) == 1, "the replicas differ"
    assert all(r[mode]["step"] == 1 for r in ranks)
    np.testing.assert_allclose(ranks[0][mode]["loss"], runs["one_loss"], rtol=1e-5)
    got = {k: runs["port"][mode][k] for k in runs["before"]}
    _hold_updates(runs, got, runs["one"], 1.0, f"{mode} against one process")
    if mode == "none":
        np.testing.assert_allclose(ranks[0][mode]["grad_norm"], runs["one_grad_norm"], rtol=1e-4)


def test_dp_step_matches_the_reference(runs, mode):
    """4 ranks against the reference's shard_map step on 4 host devices."""
    ref = runs["reference"][mode]
    got = {k: runs["port"][mode][k] for k in runs["before"]}
    assert abs(runs["ranks"][0][mode]["loss"] - ref["loss"]) < 2e-2
    extra = {"none": 0.0, "bf16": 2.0, "int8": 2.0}[mode]
    _hold_updates(runs, got, runs["ref_new"][mode], extra, f"{mode} against the reference")
    if mode == "none":
        np.testing.assert_allclose(runs["ranks"][0][mode]["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)


def test_int8_reduces_int32_on_the_wire(runs):
    """What ``all_reduce`` received, per mode: int8 sums its gradients as
    int32 after a float32 MAX of the scales; bf16 sums bf16; none sums f32;
    the loss travels as one f32 element."""
    n_params = sum(t.numel() for t in runs["before"].values())
    n_leaves = len({_stacked(k) for k in runs["before"]})
    assert n_leaves == runs["n_ref_leaves"]
    want = {"none": [("SUM", "torch.float32", n_params), ("SUM", "torch.float32", 1)],
            "bf16": [("SUM", "torch.bfloat16", n_params), ("SUM", "torch.float32", 1)],
            "int8": [("MAX", "torch.float32", n_leaves), ("SUM", "torch.int32", n_params),
                     ("SUM", "torch.float32", 1)]}
    for r in runs["ranks"]:
        for m in MODES:
            assert [(s["op"], s["dtype"], s["n"]) for s in r[m]["seen"]] == want[m], m
        assert r["int8"]["wire"] == {"max float32": n_leaves, "sum int32": n_params,
                                     "sum float32": 1}
        assert r["none"]["wire"] == {"sum float32": n_params + 1}


def test_dp_step_needs_a_multi_process_mesh():
    cfg = get_smoke_config("llama3.2-1b", **OVER)
    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="multi-process"):
        make_manual_dp_train_step(cfg, mesh, OptimizerConfig())


def test_world_of_one_equals_the_one_process_step(tmp_path):
    """A world of one rank: the DP step's all-reduces are identities, so it
    takes the one-process step bit for bit (none) on the same batch."""
    code = """
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch.train.manual_dp import make_manual_dp_train_step

    cfg = get_smoke_config("joinml-oracle", num_layers=2, dtype="float32")
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 12))}
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=0)
    p, q = init_params(cfg, device="cpu"), init_params(cfg, device="cpu")
    step = make_manual_dp_train_step(cfg, make_mesh((1,), ("data",), device="cpu"), ocfg)
    p, _, m = step(p, init_opt_state(p), batch)
    q, _, mq = make_train_step(cfg, ocfg)(q, init_opt_state(q), batch)
    assert float(m["loss"]) == float(mq["loss"])
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), q.parameters()))
    print("OK")
    """
    assert "OK" in run_ranks(code, 1, tmp_path)[0]
