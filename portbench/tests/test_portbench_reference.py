"""The plain reference held to the port on the CPU at small sizes: the
stratification, the exact answers, the scorer's batches and the f32
forward of the served MoE decoder."""
import numpy as np
import pytest
import torch

from harness.spec import load_module
from oracles.model import install, make_weights, model_config
from reference import olmoe, sweep, tokens, truth


def _clustered(seed, rows=(300, 257), d=16, entities=8):
    return load_module("tables", "clustered").make(
        {"rows": list(rows), "d": d, "entities": entities, "noise": 0.35, "corpus_seed": seed},
        seed, "cpu")


@pytest.mark.parametrize("budget", [2000, 20000])
def test_sweep_matches_the_ports_stratification(budget):
    from repro_torch.core import BASConfig
    from repro_torch.core.stratify import stratify_streaming_chain

    t = _clustered(3)
    n1, n2 = t.sizes
    strat = stratify_streaming_chain(t.emb, 0.2, budget, BASConfig(), n_bins=256,
                                     use_kernel=True, device="cpu")
    m, k = sweep.blocking_size(budget, n1 * n2)
    ref = sweep.sweep(t.emb[0], t.emb[1], 256, keep=m + 64, block_rows=64, device="cpu")
    got = sweep.Strata(strat.sweep.counts, strat.order, strat.bounds,
                       strat.sweep.row_sums[0], strat.sweep.total_weight)
    assert len(strat.bounds) == k + 1 and len(strat.order) == m
    nums = sweep.judge(got, ref, *t.emb)
    assert nums["hist_l1"] == 0.0
    assert nums["strata_gap"] < 1e-6
    assert nums["rowsum_rel"] < 1e-6
    # the reference's own cut judges itself perfect
    mine = sweep.judge(sweep.as_strata(ref, m, k), ref, *t.emb)
    assert mine["hist_l1"] == 0.0 and mine["strata_gap"] <= 1e-7


def test_sweep_block_rows_do_not_change_it():
    t = _clustered(5)
    a = sweep.sweep(t.emb[0], t.emb[1], 128, keep=500, block_rows=7, device="cpu")
    b = sweep.sweep(t.emb[0], t.emb[1], 128, keep=500, block_rows=1000, device="cpu")
    assert np.array_equal(a.counts, b.counts)
    assert np.array_equal(np.sort(a.top), np.sort(b.top))
    np.testing.assert_allclose(a.row_sums, b.row_sums, rtol=1e-12)
    w = sweep.exact_weights(t.emb[0], t.emb[1], np.arange(t.sizes[0] * t.sizes[1]))
    assert a.counts.sum() == w.size
    np.testing.assert_allclose(np.sort(w)[::-1][:500], np.sort(sweep.exact_weights(
        t.emb[0], t.emb[1], a.top))[::-1], atol=1e-6)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159])
    y = sweep.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10
    assert y[2] == 1.0                      # a tie goes to the even mantissa
    assert y[3] == 1.0 + 2**-9
    assert abs(float(y[4]) + 3.14159) < 2**-10 * 4


@pytest.mark.parametrize("agg,expr", [("COUNT", "*"), ("SUM", "a.value"), ("AVG", "b.value")])
def test_exact_answers_against_every_pair(agg, expr):
    t = _clustered(11, rows=(40, 33))
    match = t.ids[0][:, None] == t.ids[1][None, :]
    count = match.sum()
    brute = {"COUNT": float(count),
             "SUM": float((match * t.columns[0]["value"][:, None]).sum()),
             "AVG": float((match * t.columns[1]["value"][None, :]).sum() / count)}[agg]
    assert truth.aggregate(agg, expr, t.ids, t.columns) == pytest.approx(brute, rel=1e-12)


def _scorer(cfg, weights, left, right, batch, max_len=64):
    from repro_torch.data.pipeline import ByteTokenizer, pair_example
    from repro_torch.serve import PairScorer

    tok = ByteTokenizer()

    def tokenize_pair(pair):
        t, _ = pair_example(tok, left[pair[0]], right[pair[1]], None, max_len)
        return t[t != tok.PAD]

    return PairScorer(cfg, install(cfg, weights), tokenize_pair, tok.YES, tok.NO,
                      max_len=max_len, batch_size=batch, device="cpu")


def _names(seed=2, entities=24):
    return load_module("tables", "entity_names").make(
        {"entities": entities, "records_per_entity": 4, "noise": 0.1, "d": 32,
         "corpus_seed": seed}, seed, "cpu")


def test_prompts_and_batches_are_the_scorers():
    from repro_torch.data.pipeline import ByteTokenizer, pair_example

    t = _names()
    left, right = t.records
    tok = ByteTokenizer()
    long = "x" * 40
    for r1, r2 in [(left[0], right[3]), (long, right[1]), (left[2], long)]:
        ref, _ = pair_example(tok, r1, r2, None, 64)
        assert np.array_equal(tokens.prompt(r1, r2, 64), ref[ref != tok.PAD])
    rng = np.random.default_rng(0)
    pairs = np.stack([rng.integers(0, len(left), 50), rng.integers(0, len(right), 50)], 1)
    pairs[::7] = [0, 0]
    lens = tokens.prompt_lengths(pairs, left, right, 64)
    assert np.array_equal(lens, [len(tokens.prompt(left[a], right[b], 64)) for a, b in pairs])

    cfg = model_config(dict(_MODEL, moe_capacity_factor=8.0))
    seen = []
    sc = _scorer(cfg, make_weights(cfg, 1, "cpu"), left, right, batch=16)
    sc._fwd = lambda p, b: (seen.append(b["tokens"].numpy().copy()),
                            torch.zeros(*b["tokens"].shape, cfg.vocab_size))[1]
    sc.score(pairs)
    got = tokens.batches(pairs, left, right, 64, 16)
    assert len(got) == len(seen)
    for (rows, toks, last), fed in zip(got, seen):
        assert np.array_equal(toks, fed)
        assert np.array_equal(last[:len(rows)], lens[rows] - 1)


_MODEL = dict(name="olmoe-smoke", family="moe", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=300, num_experts=8,
              num_experts_per_tok=2, act="silu", rope_theta=10000.0, norm_eps=1e-5,
              dtype="float32", tied_embeddings=False, moe_capacity_factor=1.25)


@pytest.mark.parametrize("capacity", [8.0, 1.25, 0.5])
def test_f32_forward_matches_the_port(capacity):
    """At f32 the port and the reference compute the same P(match), drops
    at capacity included (0.5 drops many pairs)."""
    t = _names()
    left, right = t.records
    m = dict(_MODEL, moe_capacity_factor=capacity)
    cfg = model_config(m)
    w = make_weights(cfg, 4, "cpu")
    sc = _scorer(cfg, w, left, right, batch=16)
    rng = np.random.default_rng(1)
    pairs = np.stack([rng.integers(0, len(left), 40), rng.integers(0, len(right), 40)], 1)
    got = sc.score(pairs)
    runs = tokens.batches(pairs, left, right, 64, 16)
    ref = olmoe.yes_probs(w, m, [(tk, last) for _, tk, last in runs], tokens.YES,
                          tokens.NO, device="cpu")
    for (rows, _, _), p in zip(runs, ref):
        np.testing.assert_allclose(got[rows], p[:len(rows)], atol=2e-6)


def test_fp8_control_moves_p():
    t = _names()
    left, right = t.records
    cfg = model_config(dict(_MODEL, dtype="bfloat16"))
    w = make_weights(cfg, 4, "cpu")
    runs = tokens.batches(np.array([[i, i] for i in range(16)]), left, right, 64, 16)
    batch = [(tk, last) for _, tk, last in runs]
    hi = olmoe.yes_probs(w, _MODEL, batch, tokens.YES, tokens.NO, device="cpu")[0]
    lo = olmoe.yes_probs(w, _MODEL, batch, tokens.YES, tokens.NO, fp8=True, device="cpu")[0]
    assert np.abs(hi - lo).max() > 1e-3


def test_weights_are_laid_into_the_model_without_copies():
    cfg = model_config(_MODEL)
    w = make_weights(cfg, 9, "cpu")
    params = install(cfg, w)
    for name, p in params.named_parameters():
        assert p.data_ptr() == w[name].data_ptr()
    assert float(w["layers.0.ln1"].abs().sum()) == 0.0
    assert abs(float(w["embed"].std()) - 0.02) < 0.002
    again = make_weights(cfg, 9, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
