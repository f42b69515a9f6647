"""Resharded restore (``repro_torch.checkpoint.restore(shardings=)``): the
checkpoint carries no device layout, so a checkpoint written by one world
size (or by the reference) restores as DTensors laid out on another mesh.

* The mirror of ``tests/test_substrates.py``'s reshard case on a world of
  one rank: a replicated layout, the same values, the layout asked for.
* A checkpoint the reference writes (f32, bf16 and int32 leaves) restores
  at world 2 (gloo) onto ``Shard(0)`` placements from ``sharding_for``:
  each rank's local shard is its slice of the saved array and
  ``full_tensor()`` equals the saved array bit for bit; the world then
  saves the DTensors (gathered; rank 0 writes) and that checkpoint
  restores at world 1 and at world 4 bit for bit.
* A model's ``state_dict`` restores onto ``param_shardings`` (TRAIN_RULES
  on a (2,) data mesh: the FSDP dims split over the ranks).

The worlds run one after another, ~35 s together.
"""
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.checkpoint.checkpoint import save as jax_save
from repro_torch.checkpoint.checkpoint import save
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params

from torch_ranks import run_ranks

RESTORE = """
import json
import numpy as np
from repro_torch.checkpoint.checkpoint import restore, save
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import TRAIN_RULES, sharding_for

mesh = make_mesh((WORLD,), ("data",), device="cpu")
target = {"a": np.zeros((8, 6), np.float32), "b": torch.zeros(4, 3, dtype=torch.bfloat16),
          "c": {"d": np.zeros(8, np.int32)}}
sh = {"a": sharding_for(("batch", None), (8, 6), mesh, TRAIN_RULES),
      "b": sharding_for(("batch", None), (4, 3), mesh, TRAIN_RULES),
      "c": {"d": sharding_for(("batch",), (8,), mesh, TRAIN_RULES)}}
tree, manifest = restore(f"{OUT}/{SRC_DIR}", SRC_STEP, target, shardings=sh)

def bits(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tolist()

print(json.dumps({
    "step": manifest["step"],
    "placements": {k: str(v.placements) for k, v in (("a", tree["a"]), ("b", tree["b"]),
                                                      ("d", tree["c"]["d"]))},
    "local": {"a": bits(tree["a"].to_local()), "b": bits(tree["b"].to_local()),
              "d": bits(tree["c"]["d"].to_local())},
    "full": {"a": bits(tree["a"].full_tensor()), "b": bits(tree["b"].full_tensor()),
             "d": bits(tree["c"]["d"].full_tensor())}}))
if SAVE_TO:
    save(f"{OUT}/{SAVE_TO}", 2, tree)
"""


def _saved():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
            "c": {"d": rng.integers(-1000, 1000, 8).astype(np.int32)}}


def _bits(a):
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a).tolist()


def _restore(tmp_path, world, src, step, save_to=""):
    code = f"SRC_DIR, SRC_STEP, SAVE_TO = {src!r}, {step}, {save_to!r}\n" + RESTORE
    return [json.loads(o.strip().splitlines()[-1]) for o in run_ranks(code, world, tmp_path)]


def _check(outs, want, world, step):
    for rank, o in enumerate(outs):
        assert o["step"] == step
        for key, arr in (("a", want["a"]), ("b", want["b"]), ("d", want["c"]["d"])):
            assert o["full"][key] == _bits(arr), (world, rank, key)
            rows = arr.shape[0] // world
            assert o["local"][key] == _bits(arr[rank * rows:(rank + 1) * rows]), (world, key)
            assert o["placements"][key] == ("(Shard(dim=0),)" if world > 1 else "(Replicate(),)")


def test_reference_checkpoint_reshards_across_world_sizes(tmp_path):
    want = _saved()
    jax_save(str(tmp_path / "ref"), 1, {"a": jnp.asarray(want["a"]), "b": jnp.asarray(want["b"]),
                                        "c": {"d": jnp.asarray(want["c"]["d"])}})
    _check(_restore(tmp_path, 2, "ref", 1, save_to="world2"), want, 2, 1)
    # saved at world 2 (as step 2), restored at worlds 1 and 4
    manifest = json.loads((tmp_path / "world2" / "step_00000002" / "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == ["float32", "bfloat16", "int32"]
    for world in (1, 4):
        _check(_restore(tmp_path, world, "world2", 2), want, world, 2)


def test_checkpoint_reshard_restore_mirror(tmp_path):
    """``tests/test_substrates.py::test_checkpoint_reshard_restore`` on the
    port: a (4, 4) leaf restored onto a replicated layout of the current
    (one-rank) mesh keeps its values and takes the layout asked for."""
    code = """
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import NamedSharding
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    save(OUT + "/mirror", 1, tree)
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
    sh = {"w": NamedSharding(mesh, (None, None), (Replicate(),))}
    out, _ = restore(OUT + "/mirror", 1, tree, shardings=sh)
    assert isinstance(out["w"], DTensor) and out["w"].placements == sh["w"].placements
    assert torch.equal(out["w"].full_tensor(), tree["w"])
    print("OK")
    """
    assert "OK" in run_ranks(code, 1, tmp_path)[0]


def test_model_restores_onto_param_shardings(tmp_path):
    cfg = get_smoke_config("llama3.2-1b", num_layers=1)
    model = init_params(cfg, device="cpu")
    save(str(tmp_path / "model"), 3, model)
    torch.save(model.state_dict(), tmp_path / "want.pt")
    code = """
    from repro_torch.checkpoint.checkpoint import restore
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import TRAIN_RULES
    from repro_torch.models import init_params
    from repro_torch.models.partition import param_shardings
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
    model = init_params(get_smoke_config("llama3.2-1b", num_layers=1), seed=5, device="cpu")
    sh = param_shardings(model, mesh, TRAIN_RULES)
    tree, manifest = restore(OUT + "/model", 3, model.state_dict(), shardings=sh)
    want = torch.load(OUT + "/want.pt")
    assert manifest["step"] == 3 and set(tree) == set(want)
    for k, t in tree.items():
        assert t.placements == sh[k].placements and torch.equal(t.full_tensor(), want[k]), k
    print(sh["embed"].spec, sh["layers.0.attn.wq"].spec, str(tree["embed"].placements))
    """
    out = run_ranks(code, 2, tmp_path)
    assert "(None, 'data') ('data', None) (Shard(dim=1),)" in out[0]
