"""A run with its timed path broken underneath reads ``correct`` false, once
for each fault a cell can have: half of a batch left out and the mean
taken over the rest, and answers altered where they are produced (the
estimate; the YES and NO tokens read the other way round, in every slot of
a scorer batch and in its last tenth).  (No cell trains, so none has a step
that returns its state unchanged; none spans chips, so none has an exchange
to leave out.)  The rehearsal stands in for the card; everything after the
harness's look for one runs as in a run."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

import run

LABELS, MODEL = "labels-262k.cold-fp32", "olmoe-names.count-b2k"


def _line(workload):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "77", "--seconds", "0.5",
                       "--rehearse-cpu"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def half_the_sweep(monkeypatch):
    """The sweep bins half of its row blocks and doubles their counts."""
    from repro_torch.core import stratify

    orig = stratify._kernel_sweep

    def broken(*a, **kw):
        out = orig(*a, **kw)
        half = out.block_counts[: max(len(out.block_counts) // 2, 1)]
        out.counts = 2 * half.sum(axis=0)
        return out

    monkeypatch.setattr(stratify, "_kernel_sweep", broken)


def estimate_altered(monkeypatch):
    """The estimate and its interval come out 1.5 times what was computed."""
    from repro_torch.core import bas
    from repro_torch.core.types import ConfidenceInterval

    orig = bas.bootstrap_t_ci

    def broken(*a, **kw):
        est, ci = orig(*a, **kw)
        return 1.5 * est, ConfidenceInterval(1.5 * ci.lo, 1.5 * ci.hi, ci.p)

    monkeypatch.setattr(bas, "bootstrap_t_ci", broken)


def half_the_scorer_batch(monkeypatch):
    """The scorer runs the first half of each request's pairs and gives the
    rest their mean."""
    from repro_torch.serve import serve_loop

    orig = serve_loop.PairScorer.score

    def broken(self, pairs):
        pairs = np.asarray(pairs)
        h = max(len(pairs) // 2, 1)
        got = orig(self, pairs[:h])
        return np.concatenate([got, np.full(len(pairs) - h, got.mean())])

    monkeypatch.setattr(serve_loop.PairScorer, "score", broken)


def a_tenth_of_the_batch_altered(monkeypatch):
    """The last tenth of each scorer batch's slots read YES and NO the other
    way round: a tenth of the answers turned round where they are produced."""
    from repro_torch.serve import serve_loop

    orig = serve_loop._stable_yes_no_prob

    def broken(lg):
        lg = np.array(lg)
        tail = lg[len(lg) - max(len(lg) // 10, 1):]
        tail[:] = tail[:, ::-1].copy()
        return orig(lg)

    monkeypatch.setattr(serve_loop, "_stable_yes_no_prob", broken)


def answer_altered(monkeypatch):
    """The YES and NO tokens swapped where P(match) is read: every answer
    turned round, P to 1 - P."""
    from repro_torch.serve import serve_loop

    orig = serve_loop._stable_yes_no_prob
    monkeypatch.setattr(serve_loop, "_stable_yes_no_prob", lambda lg: orig(lg[:, ::-1]))


@pytest.mark.parametrize("workload,fault", [
    (LABELS, half_the_sweep), (LABELS, estimate_altered),
    (MODEL, half_the_sweep), (MODEL, half_the_scorer_batch),
    (MODEL, a_tenth_of_the_batch_altered), (MODEL, answer_altered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    assert _line(workload)["correct"] is False


@pytest.mark.parametrize("workload", [LABELS, MODEL])
def test_the_unbroken_path_is_correct(workload):
    assert _line(workload)["correct"] is True
