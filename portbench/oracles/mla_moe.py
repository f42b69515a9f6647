"""Oracle kind ``mla_moe``: a served DeepSeek-V3-style model (latent
attention, a sigmoid router with a selection bias, shared experts, dropless
dispatch) labels each pair, through the system's ``ModelOracle`` over its
``PairScorer``, as kind ``model`` does for its MoE.

The configuration's ``model`` keys go to the system's ``ModelConfig``
whole, not filtered to the fields it has: a program without latent
attention or these router options refuses them at set-up (a ``TypeError``)
instead of building another model under this name.

Weights: kind ``model``'s draw (normal; 0.02 for the embedding,
1/sqrt(fan-in) for a matrix, norms 0), and then each layer's router bias
from a stream of its own, normal times the oracle's ``router_bias_std``.
The window's scoring, the threshold and the choice of replayed batches
are kind ``model``'s.

The comparison holds the choice of experts and the arithmetic apart, and
reads real token positions only (a row's prompt, not its padding, nor a
batch's all-pad rows).  At
random weights the router's sigmoid scores crowd the top 6 of 64, so in
a tenth of the tokens or more an expert lies within bf16 rounding of the
6th; a bf16 forward and the f32 one then pick differently, each such flip
moves a token by a whole expert's output (about 0.4 of the layer's routed
sum), and 26 layers compound the flips until the two forwards' answers
no longer compare (more than half the pairs past ``FAR``, whatever the
precision).  So each checked batch is scored again through the system's
own scorer inside ``telemetry.tapping("moe.routes")``, which hands over
the experts every MoE layer ran (the replay must give the window's
P(match) bit for bit: ``replay_gap``), and the plain f32 forward
(``reference/moonlight.py``) runs with those experts laid over its own
choice:

* ``far_share``: the share of the pairs whose log-odds of a match, served
  and reference, lie more than ``FAR`` apart (kind ``model``'s number);
* ``route_miss``: the share of (token, MoE layer) choices where the
  system's experts fall short of the reference's own top 6 (by score +
  bias, on the reference's own hidden state) by more than ``ROUTE_TOL``:
  a near tie lost to rounding falls short by a little; a router that
  ignores its bias, or reads another layer's, by its bias's spread;
* ``router_gap``: the most by which the system's experts fall short of
  the reference router's top 6 (sigmoid of the f32 product, plus the
  bias) on the system's own router input, which the replay also hands
  over (``moe.router_in``).  The same input leaves only the router's own
  arithmetic: an f32 router reads 0 or a few f32 roundings; one that
  rounds its product to bf16, or scales or flips its bias, falls short by
  its error, well inside the hidden state's own bf16 noise that
  ``route_miss`` has to allow.

The control takes the system's place whole: the fp8 forward (its router's
product too) with its own routing, held to the f32 forward laid over the
fp8 forward's experts, and its router to the f32 router on its own input.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.capture import RecordingScorer
from harness.common import rng, sub_seed
from harness.spec import load_module
from reference import moonlight, tokens

_model = load_module("oracles", "model")


def model_config(model: dict):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**model)


def make_weights(cfg, seed: int, device, bias_std: float) -> dict:
    """name -> tensor of every parameter of the system's model for ``cfg``:
    kind ``model``'s draw, the router biases drawn afresh."""
    out = _model.make_weights(cfg, seed, device)
    g = torch.Generator(device=torch.device(device)).manual_seed(sub_seed(seed, "router-bias"))
    for name in sorted(n for n in out if n.endswith("router_bias")):
        t = out[name]
        t.normal_(generator=g).mul_(bias_std)
    return out


# frozen counts of the useful operations, 2 a multiply-add, from the
# configuration's keys alone
def token_flops(m: dict) -> float:
    """One token through the stack: latent attention's projections, the
    dense layers' MLP, the MoE's router, its k experts and the shared one."""
    d, nh = m["d_model"], m["num_heads"]
    nope, rope, dv, kvl = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                           m["kv_lora_rank"])
    mla = d * nh * (nope + rope) + d * (kvl + rope) + kvl * nh * (nope + dv) + nh * dv * d
    ff = m["moe_d_ff"]
    moe = d * m["num_experts"] + 3 * d * ff * (m["num_experts_per_tok"] + m["shared_experts"])
    dense, n_dense = 3 * d * m["d_ff"], m["first_dense_layers"]
    return 2.0 * (m["num_layers"] * mla + n_dense * dense + (m["num_layers"] - n_dense) * moe)


def attention_flops_per_pair(m: dict) -> float:
    """q k^T over nope + rope and P v over v_head_dim, a (query, key) pair."""
    return 2.0 * m["num_layers"] * m["num_heads"] * (
        m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"])


def head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


class Side(_model.Side):
    def __init__(self, session):
        from repro_torch.core import ModelOracle
        from repro_torch.data.pipeline import ByteTokenizer, pair_example
        from repro_torch.serve import PairScorer

        conf = session.config
        self.model = conf["model"]
        self.scoring = conf["scorer"]
        self.left, self.right = session.tables.records
        self.cfg = model_config(self.model)
        self.weights = make_weights(self.cfg, session.seed, session.device,
                                    float(conf["oracle"]["router_bias_std"]))
        tok = ByteTokenizer()
        left, right, max_len = self.left, self.right, self.scoring["max_len"]

        def tokenize_pair(pair):
            t, _ = pair_example(tok, left[pair[0]], right[pair[1]], None, max_len)
            return t[t != tok.PAD]

        scorer = PairScorer(self.cfg, _model.install(self.cfg, self.weights), tokenize_pair,
                            tok.YES, tok.NO, max_len=max_len,
                            batch_size=self.scoring["batch"], device=session.device)
        self.scorer = RecordingScorer(scorer)
        gen = rng(session.seed, "threshold")
        n = int(conf["oracle"]["threshold_pairs"])
        sample = np.stack([gen.integers(0, len(left), n), gen.integers(0, len(right), n)], 1)
        self.threshold = float(np.quantile(self.scorer.score(sample),
                                           conf["oracle"]["threshold_quantile"]))
        self.factory = lambda nl, names: ModelOracle(self.scorer, self.threshold)
        # each MoE layer's router, named as the reference's layer weights
        self.routers = [{f"moe.{n}": self.weights[f"layers.{i}.moe.{n}"].float()
                         for n in ("router", "router_bias")
                         if f"layers.{i}.moe.{n}" in self.weights}
                        for i in range(self.cfg.num_layers)
                        if f"layers.{i}.moe.router" in self.weights]
        self._pairs0 = 0
        self._last = None

    def window_flops(self) -> float:
        """Useful model operations of every pair scored in the window: each
        unpadded prompt through the stack, causal attention's pairs, the
        head at the one position read."""
        if not self.scorer.calls:
            return 0.0
        lens = np.concatenate([
            tokens.prompt_lengths(pairs, self.left, self.right, self.scoring["max_len"])
            for pairs, _ in self.scorer.calls])
        m = self.model
        return float(lens.sum() * token_flops(m) + len(lens) * head_flops(m)
                     + attention_flops_per_pair(m) * (lens * (lens + 1) // 2).sum())

    # ---- the comparison --------------------------------------------------

    def _chosen(self, session) -> list:
        """``check_batches`` of the window's scorer batches, drawn from the
        seed: (pairs, tokens, last, served P(match))."""
        runs = []
        for pairs, probs in self.scorer.calls:
            for rows, toks, last in tokens.batches(pairs, self.left, self.right,
                                                   self.scoring["max_len"],
                                                   self.scoring["batch"]):
                runs.append((pairs[rows], toks, last, probs[rows]))
        n = min(int(session.config["oracle"]["check_batches"]), len(runs))
        pick = rng(session.seed, "check").choice(len(runs), n, replace=False)
        return [runs[i] for i in sorted(pick)]

    def _replay(self, pairs: np.ndarray) -> tuple:
        """(P(match), the experts of each MoE layer, their margins against
        the reference router on the system's router input: (MoE layers,
        B * S)) of one scorer batch, scored again by the system (after the
        window)."""
        from repro_torch.obs import telemetry

        with telemetry.tapping("moe.routes", "moe.router_in") as taps:
            probs = self.scorer.scorer.score(pairs)
        routes = [t.detach() for t in taps["moe.routes"]]
        gaps = torch.stack([
            moonlight.route(x.float(), w, self.model, forced=r)[2]
            for x, r, w in zip(taps["moe.router_in"], routes, self.routers)])
        return probs, routes, gaps.double().cpu().numpy()

    @staticmethod
    def _real(chosen) -> list:
        """For each chosen batch, which of its B * S positions hold a
        prompt's token (not padding, nor an all-pad row)."""
        out = []
        for pairs, toks, last, _ in chosen:
            b, s = toks.shape
            out.append(((np.arange(s)[None, :] <= np.asarray(last)[:, None])
                        & (np.arange(b)[:, None] < len(pairs))).ravel())
        return out

    def _forward(self, session, chosen, fp8: bool, routes=None, margins=None,
                 chose=None) -> np.ndarray:
        """P(match) of the chosen batches' pairs by the plain forward."""
        got = moonlight.yes_probs(self.weights, self.model,
                                  [(t, last) for _, t, last, _ in chosen],
                                  tokens.YES, tokens.NO, fp8=fp8, device=session.device,
                                  routes=routes, margins=margins, chose=chose)
        return np.concatenate([p[:len(pairs)] for (pairs, _, _, _), p in zip(chosen, got)])

    @staticmethod
    def _at_real(margins: list, real: list) -> np.ndarray:
        """The margins (one (MoE layers, B * S) array a batch) at real
        positions, flat."""
        return np.concatenate([m[:, r].ravel() for m, r in zip(margins, real)])

    def checks(self, session, records: list) -> dict:
        if not self.scorer.calls:
            return {}
        chosen = self._chosen(session)
        real = self._real(chosen)
        replays = [self._replay(pairs) for pairs, _, _, _ in chosen]
        served = np.concatenate([probs for _, _, _, probs in chosen])
        replayed = np.concatenate([p for p, _, _ in replays])
        margins = []
        ref = self._forward(session, chosen, False, [r for _, r, _ in replays], margins)
        self._last = (chosen, ref)
        self.gaps = {"program": _model.logit_gaps(served, ref)}
        self.margins = {"program": margins}
        return {"far_share": _model.far_share(self.gaps["program"]),
                "route_miss": float(np.mean(self._at_real(margins, real) > ROUTE_TOL)),
                "router_gap": float(self._at_real([g for _, _, g in replays], real).max()),
                "replay_gap": float(np.abs(replayed - served).max())}

    def control(self, session, records: list) -> dict:
        """The fp8 forward in the system's place: its own routing, held to
        the f32 forward laid over its experts, and its router to the f32
        router on its own input, on the batches ``checks`` just
        compared."""
        if self._last is None:
            return {}
        chosen, chose, margins, router = self._last[0], [], [], []
        real = self._real(chosen)
        low = self._forward(session, chosen, True, margins=router, chose=chose)
        ref = self._forward(session, chosen, False, chose, margins)
        self.gaps["control"] = _model.logit_gaps(low, ref)
        self.margins["control"] = margins
        return {"far_share": _model.far_share(self.gaps["control"]),
                "route_miss": float(np.mean(self._at_real(margins, real) > ROUTE_TOL)),
                "router_gap": float(self._at_real(router, real).max()), "replay_gap": 0.0}


# how far short of the reference's own 6th (in score + bias) a forced
# expert may fall as a near tie lost to rounding: the served bf16 model's
# worst over 3 seeds on an H100 fell 0.031 short, 1 choice in 1.7 million
# beyond 0.03 and 1 in 61,000 beyond 0.02, over every position, padding
# included (PERF.md §2)
ROUTE_TOL = 0.02
