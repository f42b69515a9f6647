"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout,
and the files it names under ``portbench/``.

Everything that belongs to one configuration, one traffic mix or one
metric lives in a file of its own, found by name:

* ``configs/<config>.json``: the configuration (``file`` in BENCHMARK.json);
* ``mixes/<traffic>.json``: the traffic mix of a cell;
* ``metrics/<metric>.py``: the reader of one metric, end-to-end or per-layer;
* ``tables/<kind>.py`` and ``oracles/<kind>.py``: the generator of a
  configuration's tables and the kind of its Oracle, named by the
  configuration's ``tables.kind`` and ``oracle.kind``.

So a later change adds a cell, a mix or a metric by adding files, and edits
none that is here.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
REPO = PORTBENCH.parent
BENCHMARK = REPO / "BENCHMARK.json"

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked_name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_module(kind: str, name: str, root: Path = PORTBENCH):
    """``<root>/<kind>/<name>.py`` as a module of its own."""
    path = root / kind / f"{_checked_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    mod_name = f"portbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str, root: Path = PORTBENCH) -> dict:
    path = root / kind / f"{_checked_name(name)}.json"
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


@dataclasses.dataclass
class Metric:
    entry: dict          # the metric's entry in BENCHMARK.json
    kind: str            # "end_to_end" | "per_layer"
    reader: object       # its module in metrics/

    @property
    def name(self) -> str:
        return self.entry["name"]


@dataclasses.dataclass
class Cell:
    workload: dict       # the cell's entry in ``workloads``
    config: dict         # configs/<config>.json (with the rehearsal's sizes laid over)
    mix: dict            # mixes/<traffic>.json
    metrics: list        # [Metric] the cell reports, end-to-end first

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics_of(self, kind: str) -> list:
        return [m for m in self.metrics if m.kind == kind]


def _reported_in(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell_metrics(bench: dict, workload: str, root: Path = PORTBENCH) -> list:
    """The metrics a cell reports: every end-to-end metric listed for it (or
    for every cell), and every per-layer metric listed for it whose
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, workload)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if _reported_in(m, workload) and m["moves"] in names]
    return ([Metric(m, "end_to_end", load_module("metrics", m["name"], root)) for m in e2e]
            + [Metric(m, "per_layer", load_module("metrics", m["name"], root)) for m in per])


def load_cell(name: str, rehearse: bool = False, bench: dict | None = None,
              root: Path = PORTBENCH) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root.parent / conf["file"]) as f:
        config = json.load(f)
    mix = load_json("mixes", w["traffic"], root)
    if rehearse:
        config = merge(config, config.get("rehearsal", {}))
        mix = merge(mix, mix.get("rehearsal", {}))
    return Cell(w, config, mix, cell_metrics(bench, name, root))
