"""The port's fault-tolerance runtime (``repro_torch.runtime.fault_tolerance``)
and training loader (``repro_torch.data.pipeline.ShardedLoader``) against
the reference's: the substrate cases of ``tests/test_substrates.py``
(retries, stragglers, preemption, the loader's determinism and shards) run
in both packages, and the draws and batches must be the same."""
import numpy as np
import pytest

import repro.data.pipeline as RD
import repro.runtime.fault_tolerance as RF
import repro_torch.data.pipeline as PD
import repro_torch.runtime.fault_tolerance as PF

PACKAGES = {"port": (PF, PD), "reference": (RF, RD)}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_retry_with_backoff(pkg):
    ft = PACKAGES[pkg][0]
    calls = {"n": 0}
    retries = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert ft.retry_with_backoff(flaky, base_delay=0.001,
                                 on_retry=lambda a, e: retries.append(a)) == "ok"
    assert calls["n"] == 3 and retries == [1, 2]
    with pytest.raises(ValueError):
        ft.retry_with_backoff(lambda: (_ for _ in ()).throw(ValueError()), base_delay=0.001)
    with pytest.raises(OSError):
        ft.retry_with_backoff(lambda: (_ for _ in ()).throw(OSError()), max_attempts=2,
                              base_delay=0.001)


def test_straggler_monitors_report_alike():
    times = [0.1] * 10 + [1.0, 0.1, 0.12, 0.5, 0.09]
    reports = {}
    for name, (ft, _) in PACKAGES.items():
        hits = []
        mon = ft.StragglerMonitor(threshold=3.0, window=8, callback=hits.append)
        for s, t in enumerate(times):
            mon.record(s, t)
        reports[name] = [(r.step, r.step_time, r.median, r.ratio) for r in hits]
        assert len(hits) == 2 and hits[0].ratio > 3.0
    assert reports["port"] == reports["reference"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_preemption_handler(pkg):
    h = PACKAGES[pkg][0].PreemptionHandler()
    assert not h.preempted
    h.install()
    h.install()            # idempotent
    h.simulate()
    assert h.preempted


def test_deterministic_skipper_draws_equal_the_references():
    for seed in (0, 42):
        a, b = PF.DeterministicSkipper(seed), RF.DeterministicSkipper(seed)
        for step in (0, 1, 7, 1000):
            np.testing.assert_array_equal(a.batch_rng(step).integers(0, 1 << 30, 16),
                                          b.batch_rng(step).integers(0, 1 << 30, 16))


def _batch_fn(rng):
    return {"x": rng.integers(0, 100, (8, 3)), "y": [rng.standard_normal((8,))]}


def test_sharded_loader_batches_and_shards_equal_the_references():
    """Host shards of the same global batch, the same stream in both
    packages, and a restart at step 5 replays it."""
    loaders = {name: [d.ShardedLoader(_batch_fn, 8, num_hosts=2, host_id=h, seed=1)
                      for h in (0, 1)] for name, (_, d) in PACKAGES.items()}
    try:
        for step in range(3):
            got = {name: [next(ld) for ld in lds] for name, lds in loaders.items()}
            full = _batch_fn(np.random.default_rng(np.random.SeedSequence([1, step])))
            for name, shards in got.items():
                for h, (s, b) in enumerate(shards):
                    assert s == step
                    np.testing.assert_array_equal(b["x"], full["x"][4 * h:4 * h + 4])
                    np.testing.assert_array_equal(b["y"][0], full["y"][0][4 * h:4 * h + 4])
        l5 = PD.ShardedLoader(_batch_fn, 8, num_hosts=2, host_id=0, seed=1, start_step=5)
        r5 = RD.ShardedLoader(_batch_fn, 8, num_hosts=2, host_id=0, seed=1, start_step=5)
        (s5, b5), (t5, c5) = next(l5), next(r5)
        assert s5 == t5 == 5 and l5.step == 6
        np.testing.assert_array_equal(b5["x"], c5["x"])
        l5.close()
        r5.close()
    finally:
        for lds in loaders.values():
            for ld in lds:
                ld.close()
    assert not l5._thread.is_alive()
    with pytest.raises(ValueError):
        PD.ShardedLoader(_batch_fn, 7, num_hosts=2)


def test_tree_slice_equals_the_references():
    jax_tree_slice = RD.jax_tree_slice
    tree = {"a": np.arange(20).reshape(10, 2), "b": [np.arange(10), (np.ones((10, 3)),)]}
    got, want = PD.tree_slice(tree, 2, 6), jax_tree_slice(tree, 2, 6)
    np.testing.assert_array_equal(got["a"], np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0], np.asarray(want["b"][0]))
    np.testing.assert_array_equal(got["b"][1][0], np.asarray(want["b"][1][0]))
    assert isinstance(got["b"][1], tuple)
