"""The port's training checkpoints (``repro_torch.checkpoint.checkpoint``)
against the reference's (``repro.checkpoint.checkpoint``): the nine failure
modes of ``tests/test_checkpoint.py``, the round trip, async and cleanup
and preemption cases of ``tests/test_substrates.py``, and the layout both
ways: a tree of f32, int32 and bf16 leaves saved by one package restores in
the other, bit for bit, and both write the same manifest."""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpoint as R
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    cleanup,
    latest_step,
    restore,
    restore_latest,
    save,
)
from repro_torch.runtime.fault_tolerance import PreemptionHandler


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2,), dtype=torch.bfloat16)},
    }


# ----------------------------------------------------------------------------
# tests/test_checkpoint.py: partial writes are invisible
# ----------------------------------------------------------------------------

def test_partial_tmp_dir_is_not_a_checkpoint(tmp_path):
    root = str(tmp_path)
    tmp = os.path.join(root, ".tmp_00000003")
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "leaf_00000.npy"), np.zeros(4))
    assert latest_step(root) is None
    out, manifest = restore_latest(root, _tree())
    assert out is None and manifest is None
    save(root, 3, _tree())
    assert latest_step(root) == 3
    assert not [d for d in os.listdir(root) if d.startswith(".tmp")]


def test_step_dir_without_manifest_is_skipped(tmp_path):
    root = str(tmp_path)
    save(root, 1, _tree())
    os.makedirs(os.path.join(root, "step_00000009"))
    assert latest_step(root) == 1


# ----------------------------------------------------------------------------
# corrupt / mismatched checkpoints fail loudly
# ----------------------------------------------------------------------------

def test_restore_missing_leaf_raises_keyerror(tmp_path):
    root = str(tmp_path)
    save(root, 1, {"w": torch.zeros((2,))})
    with pytest.raises(KeyError, match="nested/b"):
        restore(root, 1, _tree())


def test_restore_shape_mismatch_raises_valueerror(tmp_path):
    root = str(tmp_path)
    save(root, 1, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape"):
        restore(root, 1, {"w": torch.zeros((4, 4))})


def test_restore_truncated_leaf_file_raises(tmp_path):
    root = str(tmp_path)
    d = save(root, 1, {"w": torch.arange(64, dtype=torch.float32)})
    leaf = os.path.join(d, "leaf_00000.npy")
    with open(leaf, "rb") as f:
        blob = f.read()
    with open(leaf, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(Exception):
        restore(root, 1, {"w": torch.zeros((64,))})


def test_restore_corrupt_manifest_raises(tmp_path):
    root = str(tmp_path)
    d = save(root, 1, _tree())
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(json.JSONDecodeError):
        restore(root, 1, _tree())


def test_restore_wrong_dtype_leaf_swap(tmp_path):
    root = str(tmp_path)
    d = save(root, 1, {"w": torch.arange(8, dtype=torch.float32)})
    np.save(os.path.join(d, "leaf_00000.npy"), np.zeros(3, np.float64))
    with pytest.raises(ValueError):
        restore(root, 1, {"w": torch.zeros((8,))})


# ----------------------------------------------------------------------------
# overwrite + retention
# ----------------------------------------------------------------------------

def test_save_same_step_overwrites_atomically(tmp_path):
    root = str(tmp_path)
    save(root, 5, {"w": torch.zeros((2,))})
    save(root, 5, {"w": torch.full((2,), 9.0)})
    out, _ = restore(root, 5, {"w": torch.zeros((2,))})
    np.testing.assert_array_equal(out["w"].numpy(), [9.0, 9.0])


def test_cleanup_keeps_newest_and_tolerates_strays(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        save(root, s, {"w": torch.zeros((1,))})
    stray = os.path.join(root, "step_00000099")
    os.makedirs(stray)
    cleanup(root, keep_last=2)
    kept = sorted(d for d in os.listdir(root) if d.startswith("step_")
                  and os.path.isfile(os.path.join(root, d, "manifest.json")))
    assert kept == ["step_00000003", "step_00000004"]
    shutil.rmtree(stray)
    cleanup(root, keep_last=0)
    assert latest_step(root) == 4


# ----------------------------------------------------------------------------
# tests/test_substrates.py: round trip, async, preemption
# ----------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {
        "w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
        "nested": {"b": torch.ones((2,), dtype=torch.float32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }
    d = save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert os.path.basename(d) == "step_00000007"
    assert latest_step(str(tmp_path)) == 7
    out, manifest = restore(str(tmp_path), 7, tree)
    assert manifest["extra"]["note"] == "x"
    for a, b in ((out["w"], tree["w"]), (out["nested"]["b"], tree["nested"]["b"]),
                 (out["step"], tree["step"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]


def test_checkpoint_async_and_cleanup(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep_last=2)
    tree = {"w": torch.zeros((4,))}
    for s in (1, 2, 3):
        ck.save(s, tree)
    ck.wait()
    assert latest_step(str(tmp_path)) == 3 and ck.last_saved == 3
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2


def test_async_checkpoint_snapshots_before_an_in_place_update(tmp_path):
    """The trainer updates parameters in place: what was saved is the tree
    as it stood when ``save`` was called."""
    ck = AsyncCheckpointer(str(tmp_path), keep_last=2)
    w = torch.zeros((1000,))
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    out, _ = restore(str(tmp_path), 1, {"w": torch.empty(1000)})
    assert float(out["w"].abs().max()) == 0.0


def test_async_checkpoint_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker / "ck"))
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()


def test_preemption_checkpoint_flow(tmp_path):
    h = PreemptionHandler()
    saved = []
    for s in range(5):
        if s == 2:
            h.simulate()
        if h.preempted:
            save(str(tmp_path), s, {"x": torch.zeros(())})
            saved.append(s)
            break
    assert saved == [2]
    assert latest_step(str(tmp_path)) == 2


def test_shardings_wait_for_the_multi_device_trainer(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 11"):
        restore(str(tmp_path), 1, {"w": torch.zeros(2)}, shardings={"w": None})


def test_module_restores_in_place(tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    cfg = get_smoke_config("llama3.2-1b", num_layers=1)
    a, b = init_params(cfg, 0, device="cpu"), init_params(cfg, 1, device="cpu")
    save(str(tmp_path), 2, {"params": a})
    out, _ = restore_latest(str(tmp_path), {"params": b})
    assert out["params"] is b
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype == y.dtype and torch.equal(x, y), name


# ----------------------------------------------------------------------------
# the two packages read each other's checkpoints
# ----------------------------------------------------------------------------

def _mixed(seed):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-1000, 1000, (4,)).astype(np.int32)
    bf16 = rng.standard_normal((2, 3)).astype(np.float32)
    return f32, i32, bf16


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    f32, i32, bf16 = _mixed(0)
    tree = {"a": torch.from_numpy(f32), "m": {"i": torch.from_numpy(i32),
                                              "h": torch.from_numpy(bf16).to(torch.bfloat16)},
            "step": torch.tensor(3, dtype=torch.int32), "l": [torch.ones(2)]}
    save(str(tmp_path), 3, tree, extra={"by": "port"})
    target = {"a": jnp.zeros((3, 5)), "m": {"i": jnp.zeros((4,), jnp.int32),
                                            "h": jnp.zeros((2, 3), jnp.bfloat16)},
              "step": jnp.int32(0), "l": [jnp.zeros(2)]}
    out, manifest = R.restore_latest(str(tmp_path), target)
    assert manifest["extra"] == {"by": "port"} and manifest["step"] == 3
    np.testing.assert_array_equal(np.asarray(out["a"]), f32)
    np.testing.assert_array_equal(np.asarray(out["m"]["i"]), i32)
    assert out["m"]["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["m"]["h"], np.float32),
                                  tree["m"]["h"].float().numpy())
    assert int(out["step"]) == 3 and out["step"].dtype == jnp.int32
    # the same manifest as the reference writes for the same tree
    R.save(str(tmp_path / "ref"), 3, out, extra={"by": "port"})
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "step_00000003" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine == theirs


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    f32, i32, bf16 = _mixed(1)
    tree = {"a": jnp.asarray(f32), "m": {"i": jnp.asarray(i32),
                                         "h": jnp.asarray(bf16, jnp.bfloat16)},
            "step": jnp.int32(9)}
    R.save(str(tmp_path), 9, tree)
    target = {"a": torch.zeros((3, 5)), "m": {"i": torch.zeros(4, dtype=torch.int32),
                                              "h": torch.zeros((2, 3), dtype=torch.bfloat16)},
              "step": torch.tensor(0, dtype=torch.int32)}
    out, manifest = restore_latest(str(tmp_path), target)
    assert manifest["step"] == 9
    assert out["a"].dtype == torch.float32 and np.array_equal(out["a"].numpy(), f32)
    assert out["m"]["i"].dtype == torch.int32 and np.array_equal(out["m"]["i"].numpy(), i32)
    assert out["m"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["m"]["h"].float().numpy(),
                                  np.asarray(tree["m"]["h"], np.float32))
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 9
