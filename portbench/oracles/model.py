"""Oracle kind ``model``: a served language model labels each pair, through
the system's ``ModelOracle`` over its ``PairScorer``.

The benchmark makes the weights on the device from the seed, in the served
type, in one draw a type (normal; 0.02 for the embedding, 1/sqrt(fan-in)
for a matrix, whose fan-in is its second-to-last axis; norms 0), and lays
them into the system's model without copying: the reference reads the same
tensors.  The threshold says yes to the top ``1 - threshold_quantile`` of
P(match) over ``threshold_pairs`` seeded pairs, fixed at set-up.

The check replays ``check_batches`` of the scorer's batches, drawn from the
seed among those the window ran, through the plain f32 forward, and counts
the share of their pairs whose two log-odds of a match lie more than
``FAR`` apart (``far_share``).  Rounding to bf16 moves a pair that far in
one pair of some hundreds at most; the fp8 forward moves a seventh of them
or more, and a fault that alters a tenth of a batch's answers moves about
half of those.  Not the widest gap, nor a quartile: a random router's top
8 of 64 experts has near ties that bf16 rounding breaks the other way in
some tokens, and where that moves which pairs an expert's capacity drops,
a few rows move far; and the upper quartile of the served model's gaps
differs between seeds' weights by up to twice, to within 2.3x of the fp8
forward's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness.capture import RecordingScorer
from harness.common import rng, sub_seed
from harness.yardstick import attention_flops, head_flops, token_flops
from reference import olmoe, tokens


def model_config(model: dict):
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in names})


def make_weights(cfg, seed: int, device) -> dict:
    """name -> tensor of every parameter of the system's model for ``cfg``."""
    from repro_torch.models import init_params

    leaves = list(init_params(cfg, device="meta").named_parameters())
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(sub_seed(seed, "weights"))
    out = {}
    for dt in sorted({p.dtype for _, p in leaves}, key=str):
        group = [(n, p.shape) for n, p in leaves if p.dtype == dt]
        flat = torch.empty(sum(int(np.prod(s)) for _, s in group), dtype=dt, device=dev)
        flat.normal_(generator=g)
        at = 0
        for n, shape in group:
            size = int(np.prod(shape))
            t = flat[at:at + size].view(shape)
            at += size
            if n == "embed":
                t.mul_(0.02)
            elif len(shape) >= 2:
                t.mul_(float(shape[-2]) ** -0.5)
            else:
                t.zero_()
            out[n] = t
    return out


def install(cfg, weights: dict):
    """The system's model for ``cfg`` holding ``weights`` (no copy)."""
    from repro_torch.models import init_params

    params = init_params(cfg, device="meta")
    for name, t in weights.items():
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)
    return params


class Side:
    def __init__(self, session):
        from repro_torch.core import ModelOracle
        from repro_torch.data.pipeline import ByteTokenizer, pair_example
        from repro_torch.serve import PairScorer

        conf = session.config
        self.model = conf["model"]
        self.scoring = conf["scorer"]
        self.left, self.right = session.tables.records
        self.cfg = model_config(self.model)
        self.weights = make_weights(self.cfg, session.seed, session.device)
        tok = ByteTokenizer()
        left, right, max_len = self.left, self.right, self.scoring["max_len"]

        def tokenize_pair(pair):
            t, _ = pair_example(tok, left[pair[0]], right[pair[1]], None, max_len)
            return t[t != tok.PAD]

        scorer = PairScorer(self.cfg, install(self.cfg, self.weights), tokenize_pair,
                            tok.YES, tok.NO, max_len=max_len,
                            batch_size=self.scoring["batch"], device=session.device)
        self.scorer = RecordingScorer(scorer)
        gen = rng(session.seed, "threshold")
        n = int(conf["oracle"]["threshold_pairs"])
        sample = np.stack([gen.integers(0, len(left), n), gen.integers(0, len(right), n)], 1)
        self.threshold = float(np.quantile(self.scorer.score(sample),
                                           conf["oracle"]["threshold_quantile"]))
        self.factory = lambda nl, names: ModelOracle(self.scorer, self.threshold)
        self._pairs0 = 0
        self._last = None

    # ---- the window ------------------------------------------------------

    def start_window(self):
        self.scorer.calls, self.scorer.seconds = [], 0.0
        self.scorer.recording = True
        self._pairs0 = self.scorer.scorer.pairs_scored

    def stop_window(self):
        self.scorer.recording = False
        self.window_pairs = self.scorer.scorer.pairs_scored - self._pairs0
        self.window_seconds = self.scorer.seconds

    def window_flops(self) -> float:
        """Useful model operations of every pair scored in the window."""
        if not self.scorer.calls:
            return 0.0
        lens = np.concatenate([
            tokens.prompt_lengths(pairs, self.left, self.right, self.scoring["max_len"])
            for pairs, _ in self.scorer.calls])
        # attention's operations are linear in n (n + 1) / 2 for a prompt of n
        per_key = attention_flops(self.model, 1)
        return float(lens.sum() * token_flops(self.model) + len(lens) * head_flops(self.model)
                     + per_key * (lens * (lens + 1) // 2).sum())

    # ---- the comparison --------------------------------------------------

    def _chosen(self, session) -> list:
        runs = []
        for pairs, probs in self.scorer.calls:
            for rows, toks, last in tokens.batches(pairs, self.left, self.right,
                                                   self.scoring["max_len"],
                                                   self.scoring["batch"]):
                runs.append((rows, toks, last, probs))
        n = min(int(session.config["oracle"]["check_batches"]), len(runs))
        pick = rng(session.seed, "check").choice(len(runs), n, replace=False)
        return [runs[i] for i in sorted(pick)]

    def _reference(self, session, chosen, fp8: bool) -> np.ndarray:
        """P(match) of the chosen batches' pairs by the plain forward."""
        got = olmoe.yes_probs(self.weights, self.model, [(t, last) for _, t, last, _ in chosen],
                              tokens.YES, tokens.NO, fp8=fp8, device=session.device)
        return np.concatenate([p[:len(rows)] for (rows, _, _, _), p in zip(chosen, got)])

    def checks(self, session, records: list) -> dict:
        if not self.scorer.calls:
            return {}
        chosen = self._chosen(session)
        ref = self._reference(session, chosen, fp8=False)
        self._last = (chosen, ref)
        served = np.concatenate([probs[rows] for rows, _, _, probs in chosen])
        self.gaps = {"program": logit_gaps(served, ref)}
        return {"far_share": far_share(self.gaps["program"])}

    def control(self, session, records: list) -> dict:
        """The fp8 forward in the system's place, on the batches ``checks``
        just compared, against the same f32 forward."""
        if self._last is None:
            return {}
        chosen, ref = self._last
        self.gaps["control"] = logit_gaps(self._reference(session, chosen, fp8=True), ref)
        return {"far_share": far_share(self.gaps["control"])}


FAR = 0.25


def far_share(gaps: np.ndarray) -> float:
    return float(np.mean(gaps > FAR))


def logit_gaps(p: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|log-odds(p) - log-odds(ref)| a pair, each P held within [1e-12, 1 - 1e-12]."""
    def log_odds(x):
        x = np.clip(np.asarray(x, np.float64), 1e-12, 1 - 1e-12)
        return np.log(x) - np.log1p(-x)

    return np.abs(log_odds(p) - log_odds(ref))
