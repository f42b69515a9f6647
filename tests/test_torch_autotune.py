"""The port's launch autotuner (``repro_torch.kernels.autotune``) against the
reference's contract (``tests/test_chain_stats.py::test_autotune_schedule``
and ``::test_index_store_configures_autotune_cache``): nothing measured on
the CPU, one measurement per shape bucket, the winner persisted in one JSON
file that a fresh cache rereads, and a persistent ``IndexStore`` pointing
the cache next to its artifacts.  Measurement itself needs the card
(``tests/test_torch_cuda.py``); here it is replaced, as the reference's
test replaces it, and so is the card's name."""
import json

import pytest

from repro.kernels import autotune as R
from repro_torch.kernels import autotune as P

WON = (64, 2)


@pytest.fixture
def tuner(monkeypatch):
    """The port's tuner with a fake measurement (recorded) and card."""
    P.reset()
    calls = []

    def fake_measure(op, m, n, d, precision, device, cands):
        calls.append((op, m, n, d, precision, tuple(cands)))
        return cands[-1]

    monkeypatch.setattr(P, "_measure", fake_measure)
    monkeypatch.setattr(P, "candidates",
                        lambda op, m, n, d, precision, device: [(128, 1), WON])
    monkeypatch.setattr(P, "_device_kind", lambda device: "NVIDIA_H100_80GB_HBM3")
    yield calls
    P.reset()


def test_cpu_and_unconfigured_schedule_nothing(tuner):
    assert P.schedule("sim_sweep", 512, 512, 32, device="cpu") is None
    assert P.schedule("sim_sweep", 512, 512, 32, device="cuda") is None  # no cache file
    assert tuner == []
    R.reset()
    try:
        assert R.schedule("sim_sweep", 512, 512, 32, backend="cpu") is None
    finally:
        R.reset()


def test_autotune_schedule(tuner, tmp_path):
    """The reference's test_autotune_schedule on the port."""
    P.configure(tmp_path / "autotune.json")
    assert P.schedule("sim_sweep", 300, 500, 32, device="cpu") is None
    won = P.schedule("sim_sweep", 300, 500, 32, device="cuda")
    assert won == WON
    assert len(tuner) == 1 and tuner[0][1:4] == (512, 512, 32)   # the bucket shape
    # same bucket: served from memory, no re-measurement
    assert P.schedule("sim_sweep", 280, 510, 32, device="cuda") == won
    assert len(tuner) == 1
    # another op, precision or bucket measures again
    P.schedule("sim_sweep", 300, 500, 32, "bf16", device="cuda")
    P.schedule("sim_hist", 300, 500, 32, device="cuda")
    P.schedule("sim_sweep", 3000, 500, 32, device="cuda")
    assert len(tuner) == 4
    # the winner persisted: a fresh cache (reset) rereads the disk file
    # without measuring again
    P.reset()
    P.configure(tmp_path / "autotune.json")
    assert P.schedule("sim_sweep", 300, 500, 32, device="cuda") == won
    assert len(tuner) == 4
    with pytest.raises(ValueError):
        P.schedule("sim_matmul", 8, 8, 8, device="cuda")


def test_cache_file_layout_and_corruption(tuner, tmp_path):
    """One JSON file of {key: [tile rows, split factor]}, keys (op, card,
    precision, bucket) in the reference's key format; a corrupt file is
    measured again and overwritten, and no temporary file stays behind."""
    path = tmp_path / "sub" / "autotune.json"
    P.configure(path)
    P.schedule("sim_topk", 100, 70000, 384, device="cuda")
    disk = json.loads(path.read_text())
    assert disk == {"sim_topk/cuda/NVIDIA_H100_80GB_HBM3/fp32/128x131072x512": list(WON)}
    assert R._key("sim_topk", "cuda", "NVIDIA_H100_80GB_HBM3", "fp32", 100, 70000, 384) \
        in disk
    assert P.cache_info() == {k: tuple(v) for k, v in disk.items()}
    assert [p.name for p in path.parent.iterdir()] == ["autotune.json"]
    for junk in ("{not json", "[1, 2]", '{"k": 5}'):
        path.write_text(junk)
        P.reset()
        P.configure(path)
        n = len(tuner)
        assert P.schedule("sim_topk", 100, 70000, 384, device="cuda") == WON
        assert len(tuner) == n + 1
        assert json.loads(path.read_text()) == disk


def test_index_store_configures_autotune_cache(tuner, tmp_path):
    """Opening a persistent IndexStore points the cache next to the index
    artifacts, so tuned launches ship with the store (both packages)."""
    from repro_torch.core import IndexStore

    IndexStore(root=tmp_path, device="cpu")
    assert P.schedule("sim_sweep", 128, 128, 32, device="cuda") == WON
    assert (tmp_path / "autotune.json").exists()

    from repro.core import IndexStore as RIndexStore

    R.reset()
    try:
        RIndexStore(root=tmp_path / "ref")
        assert R._path == str(tmp_path / "ref" / "autotune.json")
    finally:
        R.reset()
