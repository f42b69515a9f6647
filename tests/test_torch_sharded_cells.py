"""The dry run's train cells on the sharded step (``launch.cells.build_cell``
with ``train_4k``): on the 16 x 16 production mesh of a fake world of 256
ranks, every architecture's cell takes the reference's 8 microbatches
(``DEFAULT_MICROBATCHES``, and its ``accum_scan`` trip hint), its
parameters and AdamW moments are meta DTensors of which the rank holds its
blocks in the reference's layout (``param_bytes_sharded``: the FSDP dims
over "data", the tensor-parallel dims over "model"), and a traced cell's
record (``launch.dryrun.run_cell``) carries its microbatches and its
all-gather, reduce-scatter and all-reduce bytes by link.  All in one
subprocess, ~15 s.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.launch.cells as RC
from repro_torch.configs import ARCHS

ROOT = Path(__file__).resolve().parents[1]

CELLS = r"""
import json, sys, tempfile
import repro_torch.launch.cells as C
from repro_torch.configs import ARCHS
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import make_production_mesh

out = {"cells": {}}
with fake_world(256):
    mesh = make_production_mesh(device="meta")
    for arch in ARCHS:
        cell = C.build_cell(arch, "train_4k", mesh)
        params, opt, batch = cell.args
        kinds = {type(p).__name__ for p in params.parameters()}
        moments = {type(t).__name__ for key in ("m", "v") for t in opt[key].values()}
        same = all(opt[key][k].placements == p.placements and opt[key][k].shape == p.shape
                   for key in ("m", "v") for k, p in params.named_parameters())
        out["cells"][arch] = dict(
            num_microbatches=cell.num_microbatches, trip_hints=cell.trip_hints,
            kinds=sorted(kinds), moments=sorted(moments), same_layout=same,
            held=C.tree_bytes(params), sharded=C.param_bytes_sharded(cell, mesh),
            whole=C.whole_bytes(params), moment_bytes=C.tree_bytes([opt["m"], opt["v"]]),
            local_elements=sum(p._local_tensor.numel() for p in params.parameters()))
with tempfile.TemporaryDirectory() as d:
    out["record"] = run_cell("llama3.2-1b", "train_4k", False, d)
print("RESULT " + json.dumps(out, default=float))
"""


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", CELLS], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT ", 1)[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_takes_the_references_microbatches(cells, arch):
    rec = cells["cells"][arch]
    assert RC.DEFAULT_MICROBATCHES == 8
    assert rec["num_microbatches"] == 8 and rec["trip_hints"]["accum_scan"] == 8
    assert rec["trip_hints"] == RC._trip_hints(RC.get_config(arch), "train_4k", 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_holds_its_blocks(cells, arch):
    """Parameters and both moments are DTensors of one layout; the rank
    holds the reference's layout's bytes of the parameters, and 8 bytes an
    element it holds for the f32 moments."""
    rec = cells["cells"][arch]
    assert rec["kinds"] == rec["moments"] == ["DTensor"] and rec["same_layout"]
    assert rec["held"] == rec["sharded"] < rec["whole"]
    assert rec["moment_bytes"] == 8 * rec["local_elements"]


def test_traced_record_carries_its_collectives(cells):
    """A traced 16 x 16 train cell: its record says 8 microbatches, fits the
    card, and splits its collective bytes by op and link, summing to
    ``collective_links``; every group of the mesh crosses nodes."""
    rec = cells["record"]
    assert rec["status"] == "ok" and rec["num_microbatches"] == 8 and rec["fits"]
    by_op = rec["collective_by_op"]
    assert set(by_op) == {"_allgather_base_", "_reduce_scatter_base_", "allreduce_"}
    assert all(set(links) == {"net"} for links in by_op.values())
    assert sum(v["net"] for v in by_op.values()) == rec["collective_links"]["net"]
    assert {op: sum(v.values()) for op, v in by_op.items()} == rec["collective_ops"]
    assert rec["param_bytes_sharded"] < rec["param_bytes"]
    assert rec["memory"]["argument_bytes"] < rec["param_bytes"]
