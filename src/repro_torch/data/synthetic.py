"""Synthetic dataset suite mirroring the paper's evaluation data (App. C).

Two generators:

* :func:`make_clustered_tables` — embedding-realistic datasets: records are
  noisy copies of latent entity vectors; two records match iff they share an
  entity.  Noise controls embedding quality (FP/FN rates emerge naturally,
  like Company/Quora/VeRi).  Presets below mirror the paper's workloads at
  test scale.
* :func:`make_syn_scores` — the paper's Syn(FNR, FPR) stress test: scores
  sampled from Beta(5, 0.5) for matches and Beta(0.5, 5) for non-matches
  (following SUPG [37]), with score distributions *inverted* for controlled
  fractions of pairs to inject exact false-negative / false-positive rates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.oracle import ArrayOracle, PairChainOracle
from repro_torch.core.similarity import normalize
from repro_torch.core.types import JoinSpec


@dataclasses.dataclass
class PairDataset:
    name: str
    emb1: np.ndarray
    emb2: np.ndarray
    truth: np.ndarray                    # (n1, n2) in {0,1}
    columns1: dict = dataclasses.field(default_factory=dict)
    columns2: dict = dataclasses.field(default_factory=dict)
    weights_override: Optional[np.ndarray] = None  # flat scores (Syn datasets)

    @property
    def selectivity(self) -> float:
        return float(self.truth.mean())

    def spec(self) -> JoinSpec:
        return JoinSpec(embeddings=[self.emb1, self.emb2])

    def oracle(self) -> ArrayOracle:
        return ArrayOracle(self.truth)

    def truth_flat(self) -> np.ndarray:
        return self.truth.reshape(-1).astype(np.float64)


def make_clustered_tables(
    n1: int,
    n2: int,
    d: int = 64,
    n_entities: int = 512,
    noise: float = 0.35,
    seed: int = 0,
    self_join: bool = False,
    name: str = "clustered",
    n_groups: int = 0,
) -> PairDataset:
    """``n_groups > 0`` arranges entities into semantic groups (e.g. companies
    of the same industry, vehicles of the same model): same-group non-matches
    have high embedding similarity — the false-positive failure mode the
    paper attributes to dense embeddings (§7.6)."""
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((n_entities, d)).astype(np.float32)
    if n_groups > 0:
        groups = rng.standard_normal((n_groups, d)).astype(np.float32)
        g_of_e = rng.integers(0, n_groups, size=n_entities)
        ents = 1.2 * groups[g_of_e] + 0.7 * ents
    e1_ids = rng.integers(0, n_entities, size=n1)
    e2_ids = e1_ids if self_join and n1 == n2 else rng.integers(0, n_entities, size=n2)
    emb1 = ents[e1_ids] + noise * rng.standard_normal((n1, d)).astype(np.float32)
    emb2 = ents[e2_ids] + noise * rng.standard_normal((n2, d)).astype(np.float32)
    truth = (e1_ids[:, None] == e2_ids[None, :]).astype(np.int8)
    if self_join:
        np.fill_diagonal(truth, 0)  # a record is not a paraphrase of itself
    cols1 = {
        "char_len": rng.lognormal(4.0, 0.6, size=n1),
        "value": rng.lognormal(2.0, 1.0, size=n1),
        "ts": np.sort(rng.uniform(0, 1e4, size=n1)),
        "n_answers": rng.poisson(3.0, size=n1).astype(np.float64) + 1.0,
    }
    cols2 = {
        "char_len": rng.lognormal(4.0, 0.6, size=n2),
        "value": rng.lognormal(2.0, 1.0, size=n2),
        "ts": np.sort(rng.uniform(0, 1e4, size=n2)) + 50.0,
        "n_answers": rng.poisson(3.0, size=n2).astype(np.float64) + 1.0,
    }
    return PairDataset(
        name=name,
        emb1=normalize(emb1),
        emb2=normalize(emb2),
        truth=truth,
        columns1=cols1,
        columns2=cols2,
    )


def make_syn_scores(
    n1: int = 1000,
    n2: int = 1000,
    selectivity: float = 1e-3,
    fnr: float = 0.0,
    fpr: float = 0.0,
    seed: int = 0,
) -> PairDataset:
    """Paper's Syn(FNR, FPR): ground truth by selectivity; scores from
    Beta(5,.5) (matches) / Beta(.5,5) (non-matches); a ``fnr`` fraction of
    matches and ``fpr`` fraction of non-matches get their score distribution
    inverted.  Embeddings are placeholders — use ``weights_override``."""
    rng = np.random.default_rng(seed)
    n = n1 * n2
    truth = (rng.random(n) < selectivity).astype(np.int8)
    pos = truth == 1
    scores = np.empty(n, np.float64)
    n_pos = int(pos.sum())
    n_neg = n - n_pos
    scores[pos] = rng.beta(5.0, 0.5, size=n_pos)
    scores[~pos] = rng.beta(0.5, 5.0, size=n_neg)
    # inject controlled failures
    flip_pos = pos & (rng.random(n) < fnr)       # matches that look unrelated
    flip_neg = (~pos) & (rng.random(n) < fpr)    # non-matches that look related
    scores[flip_pos] = rng.beta(0.5, 5.0, size=int(flip_pos.sum()))
    scores[flip_neg] = rng.beta(5.0, 0.5, size=int(flip_neg.sum()))
    d = 8
    emb = rng.standard_normal((n1, d)).astype(np.float32)
    emb2 = rng.standard_normal((n2, d)).astype(np.float32)
    rngv = np.random.default_rng(seed + 1)
    return PairDataset(
        name=f"syn_fn{fnr:g}_fp{fpr:g}",
        emb1=normalize(emb),
        emb2=normalize(emb2),
        truth=truth.reshape(n1, n2),
        columns1={"value": rngv.lognormal(2.0, 1.0, size=n1)},
        columns2={"value": rngv.lognormal(2.0, 1.0, size=n2)},
        weights_override=np.maximum(scores, 1e-6),
    )


@dataclasses.dataclass
class ChainDataset:
    name: str
    embeddings: list
    edge_truth: list  # per-edge (N_i, N_{i+1}) {0,1} matrices

    def spec(self) -> JoinSpec:
        return JoinSpec(embeddings=self.embeddings)

    def oracle(self) -> PairChainOracle:
        return PairChainOracle(self.edge_truth)

    def truth_flat(self) -> np.ndarray:
        """Dense ground truth over the chain cross product (tests only)."""
        sizes = [e.shape[0] for e in self.embeddings]
        t = np.ones((1,), np.float64)
        for i, m in enumerate(self.edge_truth):
            if i == 0:
                t = m.astype(np.float64).reshape(-1)
            else:
                t = (t.reshape(-1, sizes[i])[:, :, None] * m[None, :, :]).reshape(-1)
        return t


def make_chain_dataset(
    sizes: list[int],
    d: int = 32,
    n_entities: int = 64,
    noise: float = 0.3,
    seed: int = 0,
    name: str = "chain",
) -> ChainDataset:
    """k-table chain join (paper's Company-Scale / Ecomm-Q10/Q11 analogs):
    records share latent entities; consecutive tables match on same entity."""
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((n_entities, d)).astype(np.float32)
    ids = [rng.integers(0, n_entities, size=n) for n in sizes]
    embs = [
        normalize(ents[i] + noise * rng.standard_normal((len(i), d)).astype(np.float32))
        for i in ids
    ]
    edges = [
        (ids[j][:, None] == ids[j + 1][None, :]).astype(np.int8)
        for j in range(len(sizes) - 1)
    ]
    return ChainDataset(name=name, embeddings=embs, edge_truth=edges)


# ---------------------------------------------------------------------------
# Paper-workload presets (test-scale analogs; selectivity/modality noted).
# ---------------------------------------------------------------------------

def dataset_registry(scale: float = 1.0, seed: int = 0) -> dict:
    s = lambda n: max(int(n * scale), 64)  # noqa: E731
    return {
        # Entity resolution, low selectivity; industry-grouped FPs (Company)
        "company": lambda: make_clustered_tables(
            s(1200), s(1200), d=64, n_entities=s(4000), noise=1.0, seed=seed,
            n_groups=max(s(4000) // 80, 4), name="company"),
        # Self-join paraphrase detection, very low selectivity (Quora-like)
        "quora": lambda: make_clustered_tables(
            s(1500), s(1500), d=64, n_entities=s(1200), noise=0.8, seed=seed + 1,
            n_groups=max(s(1200) // 12, 4), self_join=True, name="quora"),
        # Duplicate posts with noisier text (Webmasters-like)
        "webmasters": lambda: make_clustered_tables(
            s(1000), s(1000), d=64, n_entities=s(800), noise=1.2, seed=seed + 2,
            n_groups=max(s(800) // 16, 4), name="webmasters"),
        # Small query set vs large gallery (Roxford-like)
        "roxford": lambda: make_clustered_tables(
            s(70), s(4000), d=64, n_entities=s(200), noise=0.9, seed=seed + 3,
            n_groups=max(s(200) // 10, 4), name="roxford"),
        # Vehicle re-id: same-model vehicles are hard negatives (VeRi-like)
        "veri": lambda: make_clustered_tables(
            s(800), s(1000), d=64, n_entities=s(150), noise=1.0, seed=seed + 4,
            n_groups=max(s(150) // 10, 4), name="veri"),
        # Cross-modal retrieval (Flickr30K-like): noisy alignment
        "flickr30k": lambda: make_clustered_tables(
            s(600), s(3000), d=64, n_entities=s(550), noise=1.3, seed=seed + 5,
            n_groups=max(s(550) // 11, 4), name="flickr30k"),
        # High-selectivity review matching (Movie-Q5-like)
        "movie": lambda: make_clustered_tables(
            s(400), s(400), d=64, n_entities=4, noise=0.9, seed=seed + 6,
            n_groups=2, name="movie"),
    }
