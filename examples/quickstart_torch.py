"""Quickstart on the PyTorch + CUDA port: approximate COUNT over a semantic
join with BAS, against WWJ and uniform sampling.

The workload of ``examples/quickstart.py`` (a synthetic Company-style entity
matching join of 800 x 800 records), run through ``repro_torch`` instead of
the JAX package.  The similarity passes and kernels run on ``--device``:

    PYTHONPATH=src python examples/quickstart_torch.py               # a CUDA card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions
"""
import argparse

from repro_torch.core import ArrayOracle, Catalog, JoinMLEngine, Table
from repro_torch.data import make_clustered_tables


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    ds = make_clustered_tables(800, 800, n_entities=1200, noise=0.4, seed=0,
                               name="companies")
    truth = float(ds.truth.sum())
    print(f"dataset: 800x800 cross product, {int(truth)} true matches "
          f"(selectivity {ds.selectivity:.2e}); device {args.device}")

    cat = Catalog()
    cat.register(Table("wiki_companies", ds.emb1, ds.columns1))
    cat.register(Table("dbpedia_companies", ds.emb2, ds.columns2))
    engine = JoinMLEngine(cat, lambda nl, names: ArrayOracle(ds.truth),
                          device=args.device)

    sql = (
        "SELECT COUNT(*) FROM wiki_companies JOIN dbpedia_companies "
        "ON NL('{wiki_companies.description} and {dbpedia_companies.description} "
        "describe the same company') "
        "ORACLE BUDGET 20000 WITH PROBABILITY 0.95"
    )
    print(f"\nquery:\n  {sql}\n")
    for method in ("bas", "wwj", "uniform"):
        res = engine.execute(sql, method=method, seed=0)
        err = abs(res.estimate - truth) / truth * 100
        print(
            f"{method:8s} estimate={res.estimate:9.1f}  truth={truth:.0f}  "
            f"err={err:5.1f}%  95% CI=[{res.ci.lo:9.1f}, {res.ci.hi:9.1f}]  "
            f"covered={res.ci.contains(truth)}  oracle_calls={res.oracle_calls}"
        )


if __name__ == "__main__":
    main()
