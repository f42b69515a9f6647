"""A mix of several clients sharing one ``OracleService`` is data alone: the
first open question's cell, ``olmoe-names.served-8``, added as a mix file
and a ``workloads`` entry to a copy of the benchmark, runs its rehearsal
with every query's Oracle attached to the service, and a metric file added
beside it reads the service's window fill."""
import json
import shutil

import run
from harness import spec
from harness.session import Session

SERVED = {"clients": 8, "loop": "closed", "entry": "JoinMLEngine.execute", "method": "auto",
          "templates": ["SELECT COUNT(*) FROM a JOIN b ON NL('same entity') "
                        "ORACLE BUDGET 2000 WITH PROBABILITY 0.95"],
          "rotation": "round robin over the templates, a new seed a query and client",
          "service": {"workers": 1, "max_wait_ms": 8, "label_store_mb": 64},
          "bas": {}, "rehearsal": {"clients": 3}}
FILL = '''"""The served mix's share of the window slots its batches filled."""
DEVICE = False


def read(ctx):
    stats = ctx.service
    return float(stats["window_fill_ratio"]) if stats else None
'''


def test_served_mix_from_files_alone(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(spec.PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "mixes" / "served-8.json").write_text(json.dumps(SERVED))
    (root / "metrics" / "window_fill_ratio.py").write_text(FILL)
    bench = json.loads(json.dumps(spec.load_benchmark()))
    bench["workloads"].append({"name": "olmoe-names.served-8", "config": "olmoe-names",
                               "traffic": "served-8", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "window_fill_ratio", "unit": "fraction",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving plane", "moves": "query_s",
                               "workloads": ["olmoe-names.served-8"]})
    cell = spec.load_cell("olmoe-names.served-8", rehearse=True, bench=bench, root=root)
    s = Session(cell, 12345, "cpu")
    s.setup()
    try:
        win = s.window(n_queries=1)
        ctx = run.Context(s, win, 0.0)
        checks = s.checks(win)
        stats = s.service.stats()
    finally:
        s.close()
    assert len(win.completed) == 3 and len(win.records) == 3
    assert stats["windows"] >= 1 and stats["segments"] > stats["windows"]
    fill = {m.name: m for m in cell.metrics}["window_fill_ratio"].reader.read(ctx)
    assert 0 < fill <= 1
    assert all(v <= cell.config["limits"][k] for k, v in checks.items()), checks
