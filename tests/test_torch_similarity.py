"""The port's similarity layer, synthetic data and interop against the
reference, on the same seeded inputs.

Pair and chain weights come from two f32 matmuls that sum in different
orders (XLA on one side, PyTorch on the other), so they are held within
2 f32 ulp of the top of the weight range (2 * 2**-23 absolute, for
exponents >= 1) and within twice the f32 error band of the weight (the dot
product's error bound through the transform's slope) of each other; a per-element 2-ulp bound is
not attainable for small weights, whose scores cancel (measured: up to a few
hundred ulp of a 1e-3 weight).  Everything computed in numpy is bit-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import similarity as ref_sim
from repro.core.types import BASConfig as RefBASConfig
from repro.data import synthetic as ref_syn
from repro_torch.core import similarity as sim
from repro_torch.data import synthetic as syn
from repro_torch.interop import bas_config_from_dict, spec_from_arrays
from repro_torch.kernels import checks

TOP_ULP = 2.0**-23

SHAPES = [(50, 70, 16), (33, 190, 32), (130, 65, 48), (7, 260, 8), (64, 64, 24)]


def _unit(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _assert_weights_close(got, want, e1, e2, exponent, floor):
    assert got.dtype == np.float64 and got.shape == want.shape
    diff = np.abs(got - want)
    if exponent >= 1.0:  # the transform does not magnify score errors
        assert diff.max() <= 2 * TOP_ULP
    s64, bound = checks.exact_scores(torch.from_numpy(e1), torch.from_numpy(e2))
    _, band = checks.weight_band(s64, bound, exponent, floor)
    assert (diff <= 2 * band.numpy()).all()


@pytest.mark.parametrize("n1,n2,d", SHAPES)
@pytest.mark.parametrize("exponent,floor", [(1.0, 1e-3), (2.5, 1e-2), (0.5, 1e-4)])
def test_pair_weights_close_to_reference(n1, n2, d, exponent, floor):
    rng = np.random.default_rng(n1 + n2 + d)
    e1, e2 = _unit(rng, n1, d), _unit(rng, n2, d)
    got = sim.pair_weights(e1, e2, exponent, floor, device="cpu")
    want = ref_sim.pair_weights(e1, e2, exponent, floor)
    _assert_weights_close(got, want, e1, e2, exponent, floor)
    # blocked and unblocked agree
    blocked = sim.pair_weights(e1, e2, exponent, floor, block=16, device="cpu")
    assert np.abs(blocked - got).max() <= 2 * TOP_ULP


def test_chain_weights_close_to_reference():
    rng = np.random.default_rng(4)
    embs = [_unit(rng, n, 16) for n in (9, 11, 13)]
    got = sim.chain_weights(embs, 2.0, 1e-3, device="cpu")
    want = ref_sim.chain_weights(embs, 2.0, 1e-3)
    assert got.shape == want.shape == (9 * 11 * 13,)
    assert np.abs(got - want).max() <= 4 * TOP_ULP


def test_walk_statistics_close_to_reference():
    rng = np.random.default_rng(5)
    embs = [_unit(rng, n, 16) for n in (30, 40, 50)]
    for got, want in zip(sim.edge_row_sums(embs, 1.5, 1e-3, block=16, device="cpu"),
                         ref_sim.edge_row_sums(embs, 1.5, 1e-3, block=16)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert sim.chain_total_weight(embs, 1.5, 1e-3, device="cpu") == pytest.approx(
        ref_sim.chain_total_weight(embs, 1.5, 1e-3), rel=1e-6)


def test_numpy_transforms_bit_equal():
    rng = np.random.default_rng(6)
    e = rng.standard_normal((40, 24)).astype(np.float32) * 3
    e[5] = 0.0  # all-zero rows quantise to zeros with scale 0
    q, s = sim.quantize_rows_int8(e)
    rq, rs = ref_sim.quantize_rows_int8(e)
    assert q.dtype == rq.dtype == np.int8
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)
    scores = rng.uniform(-0.5, 1.5, 1000)
    for exponent, floor in [(1.0, 1e-3), (3.0, 1e-2)]:
        np.testing.assert_array_equal(sim.weight_of_score(scores, exponent, floor),
                                      ref_sim.weight_of_score(scores, exponent, floor))
    np.testing.assert_array_equal(sim.normalize(e), ref_sim.normalize(e))
    embs = [sim.normalize(rng.standard_normal((n, 8))) for n in (5, 6, 7)]
    idx = np.stack([rng.integers(0, n, 50) for n in (5, 6, 7)], axis=1)
    np.testing.assert_array_equal(sim.chain_tuple_weights(embs, idx, 2.0),
                                  ref_sim.chain_tuple_weights(embs, idx, 2.0))


def test_flat_tuple_round_trip_bit_equal():
    sizes = (7, 11, 13)
    flat = np.random.default_rng(7).integers(0, 7 * 11 * 13, 500)
    tup = sim.flat_to_tuples(flat, sizes)
    np.testing.assert_array_equal(tup, ref_sim.flat_to_tuples(flat, sizes))
    assert tup.dtype == np.int64
    np.testing.assert_array_equal(sim.tuples_to_flat(tup, sizes), flat)
    np.testing.assert_array_equal(sim.tuples_to_flat(tup, sizes),
                                  ref_sim.tuples_to_flat(tup, sizes))


def _same_dataset(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y, strict=True):
                np.testing.assert_array_equal(u, v)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("kw", [
    dict(n1=90, n2=70, d=32, seed=1),
    dict(n1=60, n2=60, d=16, n_entities=30, noise=0.8, seed=2, self_join=True),
    dict(n1=50, n2=80, d=24, n_groups=4, seed=3),
])
def test_synthetic_tables_bit_equal(kw):
    _same_dataset(syn.make_clustered_tables(**kw), ref_syn.make_clustered_tables(**kw))


def test_synthetic_chain_and_registry_bit_equal():
    _same_dataset(syn.make_chain_dataset([20, 30, 25], seed=9),
                  ref_syn.make_chain_dataset([20, 30, 25], seed=9))
    _same_dataset(syn.make_syn_scores(30, 40, seed=2, fnr=0.1, fpr=0.01),
                  ref_syn.make_syn_scores(30, 40, seed=2, fnr=0.1, fpr=0.01))
    mine, theirs = syn.dataset_registry(0.05, 1), ref_syn.dataset_registry(0.05, 1)
    assert mine.keys() == theirs.keys()
    for name in ("company", "roxford"):
        _same_dataset(mine[name](), theirs[name]())


def test_bas_config_round_trip():
    ref = dataclasses.replace(RefBASConfig(), alpha=0.3, n_bootstrap=77,
                              sweep_precision="bf16", use_sweep=False)
    cfg = bas_config_from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="unknown BASConfig"):
        bas_config_from_dict({**dataclasses.asdict(ref), "bogus": 1})
    ds = ref_syn.make_clustered_tables(20, 30, seed=0)
    spec = spec_from_arrays([ds.emb1, ds.emb2])
    assert spec.sizes == (20, 30) and spec.embeddings[0].dtype == np.float32
