"""The command end to end: each cell's CPU rehearsal as a subprocess, what
its result line holds, and what the process may not hold (JAX, the JAX
package ``repro``: top-level module names compared whole, so the port
``repro_torch`` is allowed).  Also: no card, no result; a directory with
only the benchmark's files, no result; the reference imports nothing of the
program; no source of the benchmark reads ``benchmarks/`` or imports JAX."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import PORTBENCH, REPO
from harness import spec

RUN = [sys.executable, "portbench/run.py"]
# a few threads a subprocess: the test workers share the machine's cores
ENV = dict(os.environ, OMP_NUM_THREADS="2")
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _run(args, cwd=REPO, timeout=600):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=ENV)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_line(workload, trace):
    p = _run(["--workload", workload, "--seed", "4294967297", "--seconds", "1",
              "--trace", str(trace), "--rehearse-cpu"])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    cell = spec.load_cell(workload)
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m.name for m in cell.metrics_of(kind) if not m.reader.DEVICE}
    assert set(line["metrics"]) <= allowed and line["metrics"]
    assert not any("roofline" in k or "mfu" in k or "idle" in k for k in line["metrics"])
    if not trace:
        assert {"setup_s", "query_s"} <= set(line["metrics"])
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_forbidden_module_ends_the_run_without_a_result():
    code = ("import sys, types; sys.modules['jax.numpy'] = types.ModuleType('jax.numpy'); "
            "sys.path.insert(0, 'portbench'); import run; "
            f"sys.exit(run.main(['--workload', {CELLS[0]!r}, '--seed', '3', "
            "'--seconds', '0.5', '--rehearse-cpu']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=600, env=ENV)
    assert p.returncode == 3 and "jax" in p.stderr
    assert not any(s.startswith("{") for s in p.stdout.splitlines())


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, str(PORTBENCH))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        for name in list(sys.modules):
            if name.split(".")[0] in run.FORBIDDEN:
                sys.modules.pop(name)
        import repro_torch  # noqa: F401

        assert run.forbidden_modules() == []
        sys.modules["repro.core"] = object()
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for args in (["--seconds", "1"], ["--seconds", "1", "--rehearse-cpu"]):
        p = _run(["--workload", CELLS[0], "--seed", "1"] + args, cwd=tmp_path)
        assert p.returncode != 0
        assert not any(s.startswith("{") for s in p.stdout.splitlines())


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import reference.sweep, reference.olmoe, reference.tokens, reference.truth; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    tops = set(eval(p.stdout))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_source_imports_jax_or_reads_the_jax_benchmarks():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\s|\.|$)|benchmarks/",
                     re.M)
    for path in PORTBENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert not bad.search(path.read_text()), path
