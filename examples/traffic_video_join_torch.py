"""Paper §3 use case 2 — traffic analysis on the PyTorch + CUDA port: AVG
transit time between two cameras over a semantic join on vehicle identity
(VeRi-style re-id).  The workload of ``examples/traffic_video_join.py``,
run through ``repro_torch``; the similarity passes run on ``--device``:

    PYTHONPATH=src python examples/traffic_video_join_torch.py               # a CUDA card
    PYTHONPATH=src python examples/traffic_video_join_torch.py --device cpu  # plain versions
"""
import argparse

from repro_torch.core import Agg, Query, run_bas, run_wwj
from repro_torch.data import make_clustered_tables


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    ds = make_clustered_tables(700, 900, n_entities=140, noise=0.4, seed=6,
                               name="veri")
    ts1 = ds.columns1["ts"]
    ts2 = ds.columns2["ts"]

    def g(idx):
        return ts2[idx[:, 1]] - ts1[idx[:, 0]]

    m = ds.truth > 0
    true_avg = float((ts2[None, :] - ts1[:, None])[m].mean())
    print(f"cameras: {ds.truth.shape[0]} / {ds.truth.shape[1]} detections, "
          f"{int(m.sum())} same-vehicle pairs; true AVG transit = {true_avg:.2f}s; "
          f"device {args.device}\n")

    budget = 12000
    print("SELECT AVG(video2.ts - video1.ts) FROM video1 JOIN video2")
    print("ON NL('Frame {video1.frame} and Frame {video2.frame} contains the "
          f"same car.') ORACLE BUDGET {budget} WITH PROBABILITY 0.95\n")
    for name, runner in (("bas", run_bas), ("wwj", run_wwj)):
        q = Query(spec=ds.spec(), agg=Agg.AVG, oracle=ds.oracle(), g=g,
                  budget=budget, confidence=0.95)
        res = runner(q, seed=0, device=args.device)
        print(f"{name:5s} AVG ~= {res.estimate:8.2f}s  "
              f"CI=[{res.ci.lo:.2f}, {res.ci.hi:.2f}]  "
              f"err={abs(res.estimate - true_avg) / abs(true_avg):.1%}  "
              f"calls={res.oracle_calls}")


if __name__ == "__main__":
    main()
