"""Paper §3 use case 1 — plagiarism analysis on the PyTorch + CUDA port:
COUNT of sentence pairs where an article sentence paraphrases the reference
collection (self-join-style semantic join), with a budgeted Oracle and a
valid CI.  The workload of ``examples/plagiarism_analysis.py``, run through
``repro_torch``; the similarity pass runs on ``--device``:

    PYTHONPATH=src python examples/plagiarism_analysis_torch.py               # a CUDA card
    PYTHONPATH=src python examples/plagiarism_analysis_torch.py --device cpu  # plain versions
"""
import argparse

from repro_torch.core import Agg, Query, run_bas, run_uniform
from repro_torch.data import make_clustered_tables


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    # article sentences vs reference db; entities = paraphrase clusters
    ds = make_clustered_tables(120, 2500, n_entities=900, noise=0.3, seed=4,
                               name="plagiarism")
    truth = float(ds.truth.sum())
    n_article = ds.truth.shape[0]
    plag_sentences = int((ds.truth.sum(axis=1) > 0).sum())
    print(f"article: {n_article} sentences; reference db: {ds.truth.shape[1]}; "
          f"device {args.device}")
    print(f"ground truth: {int(truth)} paraphrased pairs; "
          f"{plag_sentences}/{n_article} sentences plagiarised "
          f"({plag_sentences / n_article:.1%} plagiarism score)\n")

    budget = 9000
    q = Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(), budget=budget,
              confidence=0.95)
    res = run_bas(q, seed=0, device=args.device)
    print("SELECT COUNT(*) FROM article JOIN db ON NL('{article.sentence} is "
          "paraphrased from {db.sentence}.')")
    print(f"  ORACLE BUDGET {budget} WITH PROBABILITY 0.95\n")
    print(f"BAS      COUNT ~= {res.estimate:.0f}  "
          f"CI=[{res.ci.lo:.0f}, {res.ci.hi:.0f}]  truth={truth:.0f}  "
          f"calls={res.oracle_calls}")
    q2 = Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(), budget=budget)
    res_u = run_uniform(q2, seed=0, device=args.device)
    ratio = (f"{res_u.ci.width / res.ci.width:.1f}x BAS width"
             if res.ci.width > 1e-9 else "BAS was exact")
    print(f"UNIFORM  COUNT ~= {res_u.estimate:.0f}  "
          f"CI=[{res_u.ci.lo:.0f}, {res_u.ci.hi:.0f}] ({ratio})")


if __name__ == "__main__":
    main()
