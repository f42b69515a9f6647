"""The port's serving layer against the reference's on the CPU: the pair
scorer (the Oracle endpoint), continuous-batching greedy decode, and a
``run_bas`` COUNT whose Oracle is a ``ModelOracle`` over the scorer.

Both packages hold the same parameters (``params_from_jax``) of a reduced
``joinml-oracle`` at f32.  Tolerances:
* P(match) within 1e-5 absolute: the logits agree within 2e-5 of their
  largest magnitude (``test_torch_models.py``) and P moves by at most a
  quarter of the yes/no margin's change;
* greedy tokens equal (the top two logits of every step are further apart
  than the f32 difference);
* the query's labels are equal, because the threshold sits in the widest gap
  between the reference's probabilities, so estimates and CIs agree within
  1e-6 relative, the tolerance of ``test_torch_bas.py``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro_torch.core as P
import repro_torch.data as PD
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import ByteTokenizer as JaxTokenizer
from repro.data.pipeline import make_entity_corpus as jax_entity_corpus
from repro.data.pipeline import pair_example as jax_pair_example
from repro.models import init_params as jax_init_params
from repro.serve.serve_loop import ContinuousBatcher as JaxBatcher
from repro.serve.serve_loop import PairScorer as JaxScorer
from repro.serve.serve_loop import Request as JaxRequest
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import ByteTokenizer, make_entity_corpus, pair_example
from repro_torch.interop import bas_config_from_dict, params_from_jax
from repro_torch.serve import ContinuousBatcher, PairScorer, Request

N_SIDE = 40
REC1 = [f"acme unit {i:03d}" for i in range(N_SIDE)]
REC2 = [f"acme dept {j:03d} north" for j in range(N_SIDE)]


def _tok_pair(tok, pair_example_fn):
    def tok_pair(pair):
        t, _ = pair_example_fn(tok, REC1[pair[0]], REC2[pair[1]], None, 48)
        return t[t != tok.PAD]
    return tok_pair


@pytest.fixture(scope="module")
def scorers():
    """(reference scorer, port scorer) over the same f32 parameters."""
    rtok, tok = JaxTokenizer(), ByteTokenizer()
    over = dict(vocab_size=tok.vocab_size, dtype="float32")
    rcfg = jax_smoke_config("joinml-oracle", **over)
    rparams = jax_init_params(rcfg, jax.random.key(0))
    cfg = get_smoke_config("joinml-oracle", **over)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    ref = JaxScorer(rcfg, rparams, _tok_pair(rtok, jax_pair_example), rtok.YES,
                    rtok.NO, max_len=48, batch_size=16)
    port = PairScorer(cfg, params, _tok_pair(tok, pair_example), tok.YES, tok.NO,
                      max_len=48, batch_size=16, device="cpu")
    return ref, port


def test_tokenizer_and_pair_example_match_reference():
    rtok, tok = JaxTokenizer(), ByteTokenizer()
    assert tok.vocab_size == rtok.vocab_size
    for r1, r2, label in (("acme unit 7", "acme dept 7", 1), ("x" * 40, "y" * 40, None)):
        for a, b in zip(pair_example(tok, r1, r2, label, 48),
                        jax_pair_example(rtok, r1, r2, label, 48)):
            np.testing.assert_array_equal(a, b)
    recs, ids = make_entity_corpus(16, 3, noise=0.2, seed=4)
    rrecs, rids = jax_entity_corpus(16, 3, noise=0.2, seed=4)
    assert recs == rrecs
    np.testing.assert_array_equal(ids, rids)


def test_pair_scorer_matches_reference(scorers):
    ref, port = scorers
    # ragged lengths land in the 16/32/48 buckets; a partial tail batch pads
    pairs = np.random.default_rng(0).integers(0, N_SIDE, size=(53, 2))
    want = ref.score(pairs)
    got = port.score(pairs)
    assert got.dtype == np.float64 and got.shape == (53,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert port.forward_batches == ref.forward_batches
    assert port.pairs_scored == ref.pairs_scored == 53
    assert port.score(np.zeros((0, 2), np.int64)).shape == (0,)


def test_continuous_batcher_matches_reference():
    """Two slots, five requests of different lengths: requests are admitted
    mid-flight into freed slots, and every request's greedy tokens equal the
    reference's."""
    rtok, tok = JaxTokenizer(), ByteTokenizer()
    over = dict(vocab_size=tok.vocab_size, dtype="float32")
    rcfg = jax_smoke_config("llama3.2-1b", **over)
    rparams = jax_init_params(rcfg, jax.random.key(1))
    cfg = get_smoke_config("llama3.2-1b", **over)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rcb = JaxBatcher(rcfg, rparams, batch_size=2, max_len=32, eos_id=rtok.EOS)
    cb = ContinuousBatcher(cfg, params, batch_size=2, max_len=32, eos_id=tok.EOS,
                           device="cpu")
    for i in range(5):
        prompt = np.array([tok.BOS] + tok.encode(f"req {i}: " + "ab" * i)[:12], np.int32)
        rcb.submit(JaxRequest(uid=i, prompt=prompt, max_new_tokens=3 + i))
        cb.submit(Request(uid=i, prompt=prompt, max_new_tokens=3 + i))
    want = {r.uid: r.out_tokens for r in rcb.run_until_done()}
    got = {r.uid: r.out_tokens for r in cb.run_until_done()}
    assert got == want and len(got) == 5


def _tiny_decode_cfgs(arch):
    """The reference's ``_tiny_decode_cfg`` (``tests/test_oracle_batch.py``)
    in both packages, at f32, with the same parameters."""
    over = dict(remat=False, num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=64, dtype="float32")
    rcfg = jax_smoke_config(arch, **over)
    rparams = jax_init_params(rcfg, jax.random.key(0))
    cfg = get_smoke_config(arch, **over)
    return rcfg, rparams, cfg, params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                               device="cpu")


def test_continuous_batcher_gated_admission_recurrent():
    """The mirror of the reference's test of the same name: a recurrent
    family cannot rewind per-slot state, so admission is gated — the late
    request waits for the drain and the reset and decodes exactly as it does
    alone — and every request's tokens equal the reference batcher's."""
    rcfg, rparams, cfg, params = _tiny_decode_cfgs("rwkv6-1.6b")
    assert cfg.family == "ssm"
    rng = np.random.default_rng(2)
    pa = rng.integers(7, 60, size=5).astype(np.int32)
    pb = rng.integers(7, 60, size=3).astype(np.int32)

    def run(batcher_cls, request_cls, c, p, **kw):
        cb = batcher_cls(c, p, batch_size=2, max_len=64, eos_id=1, **kw)
        assert not cb.per_slot_pos
        cb.submit(request_cls(uid=0, prompt=pa, max_new_tokens=3))
        cb.step()                      # wave 1 started: only request A on board
        cb.submit(request_cls(uid=1, prompt=pb, max_new_tokens=3))
        assert cb.global_pos > 0
        done = cb.run_until_done(max_steps=200)
        assert len(done) == 2
        return {r.uid: r.out_tokens for r in done}

    got = run(ContinuousBatcher, Request, cfg, params, device="cpu")
    solo = ContinuousBatcher(cfg, params, batch_size=2, max_len=64, eos_id=1, device="cpu")
    solo.submit(Request(uid=1, prompt=pb, max_new_tokens=3))
    assert got[1] == solo.run_until_done(max_steps=100)[0].out_tokens
    assert got == run(JaxBatcher, JaxRequest, rcfg, rparams)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-9b", "whisper-medium",
                                  "pixtral-12b"])
def test_continuous_batcher_serves_every_family(arch):
    """Three requests through two slots: mid-flight admission where the
    cache is positional (moe, encdec, vlm), waves for the hybrid; every
    request's greedy tokens equal the reference batcher's."""
    rcfg, rparams, cfg, params = _tiny_decode_cfgs(arch)
    rcb = JaxBatcher(rcfg, rparams, batch_size=2, max_len=32, eos_id=1)
    cb = ContinuousBatcher(cfg, params, batch_size=2, max_len=32, eos_id=1, device="cpu")
    assert cb.per_slot_pos == rcb.per_slot_pos == (arch != "recurrentgemma-9b")
    rng = np.random.default_rng(4)
    for i in range(3):
        prompt = rng.integers(7, 60, size=3 + 2 * i).astype(np.int32)
        rcb.submit(JaxRequest(uid=i, prompt=prompt, max_new_tokens=2 + i))
        cb.submit(Request(uid=i, prompt=prompt, max_new_tokens=2 + i))
    want = {r.uid: r.out_tokens for r in rcb.run_until_done()}
    got = {r.uid: r.out_tokens for r in cb.run_until_done()}
    assert got == want and len(got) == 3


def _threshold(probs: np.ndarray) -> float:
    """The midpoint of the widest gap between sorted probabilities in their
    middle half: a threshold no f32 difference can move a label across."""
    p = np.sort(probs)
    lo, hi = len(p) // 4, 3 * len(p) // 4
    i = lo + int(np.argmax(np.diff(p[lo:hi])))
    return float(p[i] + p[i + 1]) / 2


def test_model_oracle_query_matches_reference(scorers):
    ref, port = scorers
    everything = np.stack(np.meshgrid(np.arange(N_SIDE), np.arange(N_SIDE),
                                      indexing="ij"), -1).reshape(-1, 2)
    thr = _threshold(ref.score(everything))
    kw = dict(n1=N_SIDE, n2=N_SIDE, n_entities=60, noise=0.4, seed=11)
    rds, pds = RD.make_clustered_tables(**kw), PD.make_clustered_tables(**kw)
    rcfg = R.BASConfig(n_bootstrap=300)
    pcfg = bas_config_from_dict(dataclasses.asdict(rcfg))
    f0r, f0p = ref.forward_batches, port.forward_batches
    s0r, s0p = ref.pairs_scored, port.pairs_scored
    roracle = R.ModelOracle(ref, threshold=thr)
    poracle = P.ModelOracle(port, threshold=thr)
    want = R.run_bas(R.Query(spec=rds.spec(), agg=R.Agg.COUNT, oracle=roracle,
                             budget=400), rcfg, seed=0)
    got = P.run_bas(P.Query(spec=pds.spec(), agg=P.Agg.COUNT, oracle=poracle,
                            budget=400), pcfg, seed=0, device="cpu")
    assert got.estimate == pytest.approx(want.estimate, rel=1e-6)
    assert got.ci.lo == pytest.approx(want.ci.lo, rel=1e-6, abs=1e-9)
    assert got.ci.hi == pytest.approx(want.ci.hi, rel=1e-6, abs=1e-9)
    assert poracle.calls == roracle.calls <= 400
    # the reference's serving bounds: flushes are pre-deduped, a handful of
    # pipeline-stage batches, ceil(unique / batch) device batches + <= 1
    # tail pad per flush
    assert poracle.calls == port.pairs_scored - s0p == ref.pairs_scored - s0r
    assert poracle.batches <= 6
    assert port.forward_batches - f0p <= (
        int(np.ceil(poracle.calls / port.batch_size)) + poracle.batches)
    assert port.forward_batches - f0p == ref.forward_batches - f0r


def test_model_oracle_takes_a_callable():
    oracle = P.ModelOracle(lambda idx: idx[:, 0] / 10.0, threshold=0.45)
    got = oracle._label(np.array([[3, 0], [5, 1], [9, 2]]))
    np.testing.assert_array_equal(got, [0.0, 1.0, 1.0])


def test_scorer_refuses_parameters_on_another_device(scorers):
    _, port = scorers
    if torch.cuda.is_available():
        pytest.skip("a card is present: the parameters could move there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        PairScorer(port.cfg, port.params, port.tokenize_pair, 5, 6)


def test_launcher_scores_on_the_cpu_and_names_what_is_missing(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "joinml-oracle", "--mode", "score", "--pairs", "8",
          "--device", "cpu"])
    assert "scored 8 pairs" in capsys.readouterr().out
    # --shard, once missing, scores over the host mesh (one CPU slot here)
    main(["--arch", "joinml-oracle", "--mode", "score", "--pairs", "8", "--shard",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sharding score batches over mesh {'data': 1, 'model': 1}" in out
    assert "scored 8 pairs" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-1.6b", "recurrentgemma-9b",
                                  "whisper-medium", "pixtral-12b"])
def test_launcher_decodes_and_scores_every_family(arch, capsys):
    """``--mode decode`` for every family on the CPU, and ``--mode score``
    for every family but the encoder-decoder, which the launcher refuses
    (a pair is text only: there are no frames to score it against)."""
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--mode", "decode", "--requests", "3", "--max-new", "2",
          "--device", "cpu"])
    assert "3 requests, 6 tokens" in capsys.readouterr().out
    score = ["--arch", arch, "--mode", "score", "--pairs", "5", "--device", "cpu"]
    if arch == "whisper-medium":
        with pytest.raises(SystemExit) as exc:
            main(score)
        assert exc.value.code == 2
        assert "--mode score is not defined for whisper-medium" in capsys.readouterr().err
    else:
        main(score)
        assert "scored 5 pairs" in capsys.readouterr().out


def test_oracle_path_pairs_fill_the_48_token_bucket():
    """``chip_smoke.py`` checks and times K5 at S 48 as the Oracle path's
    shape: every pair of that path's two tables pads to the 48-token bucket
    (the pairs are 35 to 45 tokens long)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    left, right = cs.entity_tables(cs.FULL_MODEL)
    cfg = get_smoke_config("joinml-oracle")
    scorer = cs.make_scorer(cfg, init_params(cfg, device="cpu"), left, right,
                            cs.FULL_MODEL.batch, "cpu")
    lens = np.array([len(t) for t in scorer._tokenize(cs._all_pairs(len(left), len(right)))])
    assert len(lens) == 256 * 256
    assert (lens.min(), lens.max()) == (35, 45)
    assert set(scorer._buckets[np.searchsorted(scorer._buckets, lens)]) == {48}


def _launch(*args):
    """The launcher as a subprocess on the CPU, its output on a pipe."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "joinml-oracle", "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def _read_address(proc, seen, timeout=120.0):
    """Read ``proc``'s output until its ``listening on host:port`` line
    (bounded); every line read is kept in ``seen``."""
    import re
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        while sel.select(timeout=timeout):
            line = proc.stdout.readline()
            if not line:
                break
            seen.append(line)
            m = re.search(r"listening on ([0-9.]+):(\d+)", line)
            if m:
                return f"{m.group(1)}:{m.group(2)}"
    finally:
        sel.close()
    raise AssertionError(f"no bound address: {''.join(seen)}")


def test_launcher_fleet_modes_on_the_cpu():
    """``--mode worker --port 0`` and ``--mode server --port 0
    --worker-hosts`` print their bound addresses; ``--mode client``
    against the server runs its queries to the end; a terminated server
    prints its shutdown lines, with the shards its worker took."""
    w_lines, s_lines = [], []
    worker = _launch("--mode", "worker", "--port", "0")
    server = None
    try:
        w_addr = _read_address(worker, w_lines)
        server = _launch("--mode", "server", "--port", "0", "--worker-hosts",
                         w_addr, "--label-store-mb", "8")
        s_addr = _read_address(server, s_lines)
        client = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "client", "--connect", s_addr, "--queries", "3", "--budget", "300",
             "--device", "cpu"],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.join(
                os.path.dirname(os.path.dirname(__file__)), "src")
                + os.pathsep + os.environ.get("PYTHONPATH", "")))
        assert client.returncode == 0, client.stderr[-3000:]
        assert "[client] 3 queries against" in client.stdout
        assert client.stdout.count("estimate=") == 3
    finally:
        for proc in (server, worker):
            if proc is not None:
                proc.terminate()
        out = {}
        for name, proc in (("server", server), ("worker", worker)):
            if proc is not None:
                out[name] = proc.communicate(timeout=60)[0]
    s_out = "".join(s_lines) + out["server"]
    assert server.returncode == 0 and worker.returncode == 0, s_out
    assert f"registered worker {w_addr}" in s_out
    assert "[server] shut down;" in s_out and "rows labelled" in s_out
    assert "[worker] shut down;" in out["worker"]


def test_launcher_service_mode_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "joinml-oracle", "--mode", "service", "--device", "cpu",
          "--queries", "3", "--budget", "200", "--label-store-mb", "8",
          "--tracker", "memory"])
    out = capsys.readouterr().out
    assert "[serve] 3 concurrent queries" in out
    assert out.count("estimate=") == 3
    assert "store: hit_rate=" in out and "class 'default':" in out
