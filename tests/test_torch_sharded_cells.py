"""The dry run's cells on the sharded programs.  Train (``launch.cells.build_cell``
with ``train_4k``): on the 16 x 16 production mesh of a fake world of 256
ranks, every architecture's cell takes the reference's 8 microbatches
(``DEFAULT_MICROBATCHES``, and its ``accum_scan`` trip hint), its
parameters and AdamW moments are meta DTensors of which the rank holds its
blocks in the reference's layout (``param_bytes_sharded``: the FSDP dims
over "data", the tensor-parallel dims over "model"), and a traced cell's
record (``launch.dryrun.run_cell``) carries its microbatches and its
all-gather, reduce-scatter and all-reduce bytes by link.  Prefill and
decode, on 16 x 16 and 2 x 16 x 16 (fake worlds of 256 and 512 ranks):
every cell's parameters and cache are DTensors of which the rank holds
the reference's SERVE_RULES / DECODE_RULES layout, and the 8 cells that
did not fit a rank while they ran whole parameters trace and fit.  All in
one subprocess, ~25 s.
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
from repro_torch.roofline import hw

SERVING, TRACED = json.loads(sys.argv[1]), json.loads(sys.argv[2])

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
out["serving"] = {}
for multi_pod in (False, True):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        for arch in ARCHS:
            for shape in SERVING:
                if not C.cell_supported(C.get_config(arch), shape)[0]:
                    continue
                cell = C.build_cell(arch, shape, mesh)
                rec = dict(held=C.tree_bytes(cell.args[0]),
                           sharded=C.param_bytes_sharded(cell, mesh),
                           whole=C.whole_bytes(cell.args[0]),
                           kinds=sorted({type(p).__name__ for p in cell.args[0].parameters()}))
                if cell.kind == "decode":
                    rec["cache"] = C.tree_bytes(cell.args[1])
                if [arch, shape, mesh_name] in TRACED:
                    cost, memory = C.trace_cell(cell, mesh)
                    rec["hbm_fraction"] = memory["total_bytes"] / hw.HBM_BYTES
                    rec["collectives"] = cost.collective_ops
                out["serving"][f"{arch} {shape} {mesh_name}"] = rec
print("RESULT " + json.dumps(out, default=float))
"""


# the serving cells, and the 8 that did not fit a rank while prefill and
# decode ran whole parameters (and an unsplit cache): qwen3-moe-235b-a22b's
# prefill and decode on both meshes, four decode_32k cells on 16 x 16
SERVING = ["prefill_32k", "decode_32k", "long_500k"]
TRACED = [[a, s, m] for a in ["qwen3-moe-235b-a22b"] for s in ["prefill_32k", "decode_32k"]
          for m in ["16x16", "2x16x16"]] + [
    [a, "decode_32k", "16x16"]
    for a in ["llama3-8b", "olmoe-1b-7b", "mistral-nemo-12b", "pixtral-12b"]]


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", CELLS, json.dumps(SERVING),
                          json.dumps(TRACED)], capture_output=True, text=True,
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


def _serving_cells():
    return [(a, s, m) for m in ("16x16", "2x16x16") for a in ARCHS for s in SERVING
            if RC.cell_supported(RC.get_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape,mesh", _serving_cells())
def test_serving_cell_holds_the_references_layout(cells, arch, shape, mesh):
    """Every prefill and decode cell: the parameters are DTensors of which
    the rank holds the reference's layout's bytes (``param_bytes_sharded``
    under SERVE_RULES / DECODE_RULES: 2-D, "fsdp" over "data"), and a
    decode cell's cache block holds the bytes of the reference's
    ``_cache_logical_axes`` under DECODE_RULES at the cell's batch and
    slots."""
    rec = cells["serving"][f"{arch} {shape} {mesh}"]
    assert rec["kinds"] == ["DTensor"]
    assert rec["held"] == rec["sharded"] < rec["whole"]
    if shape != "prefill_32k":
        assert rec["cache"] == _reference_cache_bytes(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape,mesh", [tuple(c) for c in TRACED])
def test_cells_that_did_not_fit_now_fit(cells, arch, shape, mesh):
    """The 8 cells that took 1.035-6.738 of a card while prefill and decode
    ran whole parameters trace, collect over the mesh and fit a rank;
    qwen3-moe-235b-a22b holds the reference's 1.852 GB of weights a rank
    on 16 x 16."""
    rec = cells["serving"][f"{arch} {shape} {mesh}"]
    assert 0 < rec["hbm_fraction"] <= 1.0
    assert rec["collectives"]["allreduce_"] > 0
    if arch == "qwen3-moe-235b-a22b" and mesh == "16x16":
        assert round(rec["held"] / 1e9, 3) == 1.852


def _reference_cache_bytes(arch, shape, mesh):
    """Bytes a rank holds of the reference's decode cache: each leaf's
    ``spec_for`` of its ``_cache_logical_axes`` under DECODE_RULES."""
    import math
    import types

    import jax

    from repro.launch import sharding as RS
    from repro.models import init_cache

    sh = RC.SHAPES[shape]
    cache = jax.eval_shape(lambda: init_cache(RC.get_config(arch), sh["batch"], sh["seq"]))
    axes = jax.tree_util.tree_leaves(RC._cache_logical_axes(cache),
                                     is_leaf=lambda x: isinstance(x, tuple))
    sizes = dict(zip(("pod", "data", "model"), (2, 16, 16))) if mesh == "2x16x16" \
        else {"data": 16, "model": 16}
    ref_mesh = types.SimpleNamespace(shape=sizes)
    total = 0
    for leaf, ax in zip(jax.tree_util.tree_leaves(cache), axes):
        spec = RS.spec_for(ax, leaf.shape, RS.DECODE_RULES, ref_mesh)
        n = 1
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
                n *= sizes[a]
        total += math.prod(leaf.shape) // n * leaf.dtype.itemsize
    return total
