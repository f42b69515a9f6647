"""BENCHMARK.json against the contract's shape, every cell and metric
resolved to its files, and a cell, mix and metric added as files alone."""
import filecmp
import json
import re
import shutil

import pytest

from harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_of_24_cells_fits():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.load_cell(workload)
    e2e = {m.name for m in cell.metrics_of("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics_of("per_layer")
    for m in cell.metrics:
        assert callable(m.reader.read) and isinstance(m.reader.DEVICE, bool)
        if m.kind == "per_layer":
            assert m.entry["moves"] in e2e
    spec.load_module("tables", cell.config["tables"]["kind"])
    spec.load_module("oracles", cell.config["oracle"]["kind"])
    assert cell.config["limits"] and cell.mix["templates"]
    assert cell.config["name"] == cell.workload["config"]


def test_every_metric_has_its_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (spec.PORTBENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


def test_added_files_are_taken_up_without_an_edit(tmp_path):
    """A new mix, a new metric and a new cell over an existing configuration:
    files added and entries added to BENCHMARK.json, nothing else changed."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "mixes" / "count-b500.json").write_text(json.dumps(
        {"clients": 1, "loop": "closed", "entry": "JoinMLEngine.execute", "method": "auto",
         "templates": ["SELECT COUNT(*) FROM a JOIN b ON NL('x') ORACLE BUDGET 500 "
                       "WITH PROBABILITY 0.9"]}))
    (root / "metrics" / "queries_done.py").write_text(
        "DEVICE = False\n\n\ndef read(ctx):\n    return len(ctx.window.completed)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "labels-262k.count-b500", "config": "labels-262k",
                               "traffic": "count-b500", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "queries_done", "unit": "queries", "better": "higher",
                               "source": "host_clock", "layer": "front end",
                               "moves": "query_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("labels-262k.count-b500", bench=bench, root=root)
    assert cell.mix["templates"][0].startswith("SELECT COUNT")
    assert "queries_done" in {m.name for m in cell.metrics}
    # without a ``workloads`` key the new metric is every query_s cell's
    other = spec.load_cell("olmoe-names.count-b2k", bench=bench, root=root)
    assert "queries_done" in {m.name for m in other.metrics}
    cmp = filecmp.dircmp(spec.PORTBENCH, root, ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + [f for sub in d.subdirs.values() for f in changed(sub)]

    assert changed(cmp) == []
