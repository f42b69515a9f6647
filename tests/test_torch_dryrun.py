"""The port's dry run (``repro_torch.launch.{cells,dryrun}``) against the
reference's (``repro.launch.{cells,dryrun}``).

* The cell table: ``SHAPES``, ``DEFAULT_MICROBATCHES``, ``cell_supported``
  (40 cells, 8 skipped), ``_trip_hints`` and ``input_specs`` (meta tensors
  of the reference's shapes and types, their specs the reference's
  ``spec_for`` under the same rules).
* FLOPs against the reference's HLO analyzer: each family's smoke config,
  on a 1-device mesh, for train, prefill and decode.  The two count
  attention and the recurrences differently, so each side's term is named
  and taken out first: the reference's attention query chunks and the
  scans' time steps (its loops ``attn_q_scan``, ``enc&attn_q_scan``,
  ``rwkv_time_scan``, ``rglru_time_scan``, run 0 times), which compute
  every (query, key) pair and each step as a product; the port's kernel
  charges (``roofline.kernel_work``: K5 over the pairs its masks leave, K6
  and K7 by their recurrences).  What is left is held within 2%, and the
  reference's attention term is held to its analytic count.
* The train cell at 2 microbatches: FLOPs against the reference's
  analyzer as above (one microbatch traced, counted twice, as the
  reference's analyzer expands its ``accum_scan``) and its trip hints.
* A trace's FLOPs grow with the layers; the launches charged on meta at
  full width equal what ``chip_smoke.py`` phases 11 and 11b count on the
  card; a sharded train cell's all-gathers and reduce-scatters move its
  FSDP shards, and a 16 x 16 cell reduces the gradients of the parameters
  that no batch axis splits.
* The CLI writes a record with the reference's keys.

Every fake world runs in a subprocess (one for all the port's traces), so
no test worker keeps a process group.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import repro.launch.cells as RC
import repro_torch.launch.cells as C
from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "llama3.2-1b", "moe": "olmoe-1b-7b", "ssm": "rwkv6-1.6b",
            "hybrid": "recurrentgemma-9b", "encdec": "whisper-medium", "vlm": "pixtral-12b"}
SMOKE_SHAPES = {"train_4k": dict(kind="train", seq=32, batch=4),
                "prefill_32k": dict(kind="prefill", seq=32, batch=4),
                "decode_32k": dict(kind="decode", seq=64, batch=4)}


def _run(argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, *argv], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# ----------------------------------------------------------------------------
# the cell table
# ----------------------------------------------------------------------------

def test_cell_table_is_the_references():
    assert C.SHAPES == RC.SHAPES
    assert C.DEFAULT_MICROBATCHES == RC.DEFAULT_MICROBATCHES
    assert C.all_cells() == RC.all_cells()


def test_cell_supported_matrix():
    total = skipped = 0
    for arch in ARCHS:
        for shape in C.SHAPES:
            total += 1
            ok, why = C.cell_supported(get_config(arch), shape)
            assert (ok, why) == RC.cell_supported(ref_config(arch), shape)
            if not ok:
                skipped += 1
                assert shape == "long_500k" and not get_config(arch).supports_long_context
    assert (total, skipped) == (40, 8)


@pytest.mark.parametrize("micro", [1, 8])
def test_trip_hints_are_the_references(micro):
    for arch in ARCHS:
        for shape in C.SHAPES:
            assert C._trip_hints(get_config(arch), shape, micro) == \
                RC._trip_hints(ref_config(arch), shape, micro)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_input_specs_are_meta_with_the_references_specs(multi_pod):
    """The port's ``test_input_specs_no_allocation``: meta tensors of the
    reference's shapes and types on every cell, whose specs are the
    reference's ``spec_for`` (which reads only the mesh's axis sizes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = make_mesh(shape, axes, devices=["meta"] * (512 if multi_pod else 256))
    ref_mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    for arch in ARCHS:
        for shape_name in C.SHAPES:
            want = _ref_shapes(arch, shape_name)
            for rules in ("TRAIN_RULES", "SERVE_RULES", "DECODE_RULES"):
                got = C.input_specs(get_config(arch), shape_name, mesh, getattr(S, rules))
                assert {k: (tuple(x.shape), x.dtype) for k, x in got.items()} == want
                for k, x in got.items():
                    assert x.is_meta
                    logical = ("batch", None) if k == "tokens" else ("batch", None, None)
                    ref_spec = RS.spec_for(logical, tuple(x.shape), getattr(RS, rules),
                                           ref_mesh)
                    assert x.sharding.spec == tuple(ref_spec), (arch, shape_name, k)
    specs = C.input_specs(get_config("whisper-medium"), "train_4k", mesh, S.TRAIN_RULES)
    assert set(specs) == {"tokens", "frames"}
    assert specs["tokens"].shape == (256, 4096)
    assert specs["frames"].shape == (256, 1500, 1024)


def _ref_shapes(arch, shape_name):
    """The reference's ``input_specs`` shapes and types (on a one-device
    mesh, where every spec replicates)."""
    from repro.launch.mesh import make_host_mesh

    specs = RC.input_specs(ref_config(arch), shape_name, make_host_mesh(), RS.TRAIN_RULES)
    return {k: (tuple(s.shape), getattr(torch, str(s.dtype))) for k, s in specs.items()}


def test_cache_logical_axes_are_the_references():
    import jax

    from repro.models import init_cache as ref_init_cache
    from repro_torch.models import init_cache

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, list):
            items = enumerate(tree)
        else:
            return {prefix: tree}
        return {kk: v for k, sub in items for kk, v in flat(sub, f"{prefix}{k}.").items()}

    for arch in FAMILIES.values():
        cfg = get_config(arch)
        ours = flat(C._cache_logical_axes(init_cache(cfg, 2, 64, "meta")))
        ref_cache = jax.eval_shape(lambda c=ref_config(arch): ref_init_cache(c, 2, 64))
        assert ours == flat(RC._cache_logical_axes(ref_cache)), arch


# ----------------------------------------------------------------------------
# the port's traces, in one subprocess
# ----------------------------------------------------------------------------

PORT_TRACES = r"""
import json, sys
import repro_torch.launch.cells as C
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh

families, smoke_shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"smoke": {}, "launches": {}}
full = C.get_config


def trace(arch, shape, mesh, micro=1, **over):
    cell = C.build_cell(arch, shape, mesh, num_microbatches=micro, cfg_overrides=over or None)
    cost, memory = C.trace_cell(cell, mesh)
    return cell, cost, memory


def fsdp_bytes(cell, mesh):
    # bytes of each parameter gathered over the batch axes that split it
    # (its local block times their size), summed
    total = 0
    for p in cell.args[0].parameters():
        n = 1
        for axis, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
            if pl.is_shard() and axis in ("pod", "data"):
                n *= mesh.shape[axis]
        if n > 1:
            total += n * p._local_tensor.numel() * p.element_size()
    return total


with fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    C.SHAPES = smoke_shapes
    C.get_config = lambda name: get_smoke_config(name)
    for fam, arch in families.items():
        for shape in smoke_shapes:
            cell, cost, _ = trace(arch, shape, mesh)
            out["smoke"][f"{arch} {shape}"] = dict(
                flops=cost.flops, kernels=cell.trace.kernels,
                flop_counter=cell.trace.flop_counter_flops)
        cell, cost, _ = trace(arch, "train_4k", mesh, micro=2)
        out["smoke"][f"{arch} train_4k x2"] = dict(
            flops=cost.flops, kernels=cell.trace.kernels,
            flop_counter=cell.trace.flop_counter_flops, trip_hints=cell.trip_hints,
            num_microbatches=cell.num_microbatches)
    out["layers"] = [trace("llama3.2-1b", "train_4k", mesh, num_layers=n)[1].flops
                     for n in (1, 2)]
    # chip_smoke.py phases 11 and 11b at full width: 16 x 128 (joinml-oracle,
    # rwkv6-1.6b), 8 x 128 (recurrentgemma-9b cut to 8 layers), remat on
    C.get_config = full
    for arch, batch, over in (("joinml-oracle", 16, {}), ("rwkv6-1.6b", 16, {}),
                              ("recurrentgemma-9b", 8, {"num_layers": 8})):
        C.SHAPES = {"train_4k": dict(kind="train", seq=128, batch=batch)}
        cell, _, _ = trace(arch, "train_4k", mesh, remat=True, **over)
        out["launches"][arch] = {k: v["launches"] for k, v in cell.trace.kernels.items()}

C.SHAPES = {"train_4k": dict(kind="train", seq=32, batch=4)}
C.get_config = lambda name: get_smoke_config(name)
with fake_world(4):
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    cell, cost, _ = trace("llama3.2-1b", "train_4k", mesh, micro=2)
    out["mesh_2x2"] = dict(collective_ops=cost.collective_ops, links=dict(cell.trace.links),
                           fsdp_bytes=fsdp_bytes(cell, mesh))

C.SHAPES = {"train_4k": dict(kind="train", seq=4096, batch=256)}
C.get_config = full
with fake_world(256):
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(device="meta")
    cell, cost, memory = trace("llama3.2-1b", "train_4k", mesh, micro=None)
    out["prod_train"] = dict(
        collective_bytes=cost.collective_bytes, collective_ops=cost.collective_ops,
        links=dict(cell.trace.links), num_microbatches=cell.num_microbatches,
        fsdp_bytes=fsdp_bytes(cell, mesh), memory=memory,
        replicated=[4 * p.numel() for p in cell.args[0].parameters()
                    if not any(pl.is_shard() for pl in p.placements)],
        tokens=list(C.local(cell.args[2]["tokens"]).shape))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def port():
    out = _run(["-c", PORT_TRACES, json.dumps(FAMILIES), json.dumps(SMOKE_SHAPES)])
    return json.loads(out.split("RESULT ", 1)[1])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flops_match_the_references_analyzer(family, port, monkeypatch):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.roofline.hlo_analysis import analyze

    arch = FAMILIES[family]
    monkeypatch.setattr(RC, "SHAPES", SMOKE_SHAPES)
    monkeypatch.setattr(RC, "get_config", ref_smoke)
    mesh = make_host_mesh()
    named = ("attn_q_scan", "enc&attn_q_scan", "rwkv_time_scan", "rglru_time_scan")
    for shape, sh in SMOKE_SHAPES.items():
        cell = RC.build_cell(arch, shape, mesh, num_microbatches=1)
        hlo = RC.lower_cell(cell, mesh).compile().as_text()
        ref_all = analyze(hlo, cell.trip_hints).flops
        ref_rest = analyze(hlo, {**cell.trip_hints, **dict.fromkeys(named, 0)}).flops
        got = port["smoke"][f"{arch} {shape}"]
        kernels = sum(k["flops"] for k in got["kernels"].values())
        rest = got["flops"] - kernels
        assert rest == pytest.approx(ref_rest, rel=0.02), (shape, rest, ref_rest)
        # the flop counter sees the aten products the port dispatches, no kernel
        assert got["flop_counter"] == pytest.approx(rest, rel=1e-12)
        cfg = cell.cfg
        if family in ("dense", "moe", "vlm") and sh["kind"] != "decode":
            # the reference's attention: every (query, key) pair, two products
            # of 2 FLOPs a head dim, forward and (train) the backward's four
            passes = 3 if sh["kind"] == "train" else 1
            attn = passes * cfg.num_layers * 4.0 * sh["batch"] * cfg.num_heads \
                * sh["seq"] ** 2 * cfg.head_dim
            assert ref_all - ref_rest == attn
        if sh["kind"] == "decode":
            assert kernels == 0 and ref_all == ref_rest


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_microbatched_train_flops_match_the_references_analyzer(family, port, monkeypatch):
    """The train cell at 2 microbatches: the port traces one and counts it
    twice, the reference's analyzer runs its ``accum_scan`` twice; the FLOPs
    left when each side's attention and scan terms are out agree to 1e-6,
    and so do the trip hints."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.roofline.hlo_analysis import analyze

    arch = FAMILIES[family]
    monkeypatch.setattr(RC, "SHAPES", SMOKE_SHAPES)
    monkeypatch.setattr(RC, "get_config", ref_smoke)
    mesh = make_host_mesh()
    named = ("attn_q_scan", "enc&attn_q_scan", "rwkv_time_scan", "rglru_time_scan")
    cell = RC.build_cell(arch, "train_4k", mesh, num_microbatches=2)
    hlo = RC.lower_cell(cell, mesh).compile().as_text()
    ref_rest = analyze(hlo, {**cell.trip_hints, **dict.fromkeys(named, 0)}).flops
    got = port["smoke"][f"{arch} train_4k x2"]
    assert got["num_microbatches"] == 2
    assert got["trip_hints"] == cell.trip_hints
    assert got["trip_hints"]["accum_scan"] == 2
    rest = got["flops"] - sum(k["flops"] for k in got["kernels"].values())
    assert rest == pytest.approx(ref_rest, rel=1e-6), (rest, ref_rest)
    assert got["flop_counter"] == pytest.approx(rest, rel=1e-12)
    one = port["smoke"][f"{arch} train_4k"]
    assert {k: v["launches"] for k, v in got["kernels"].items()} == \
        {k: 2 * v["launches"] for k, v in one["kernels"].items()}


def test_flops_grow_with_the_layers(port):
    one, two = port["layers"]
    assert two > one * 1.3


def test_charged_launches_equal_the_cards(port):
    """chip_smoke.py phase 11 counts 24 K5 + 12 K5-backward launches a
    joinml-oracle step, phase 11b 48 + 24 K6 (rwkv6-1.6b) and 12 + 6 K7 with
    4 + 2 K5 (recurrentgemma-9b, 8 layers): each layer's forward runs twice
    under remat."""
    assert port["launches"] == {
        "joinml-oracle": {"flash_attention": 24, "flash_attention_bwd": 12},
        "rwkv6-1.6b": {"rwkv6_scan": 48, "rwkv6_scan_bwd": 24},
        "recurrentgemma-9b": {"rglru_scan": 12, "rglru_scan_bwd": 6,
                              "flash_attention": 4, "flash_attention_bwd": 2},
    }


def test_production_train_cell_all_reduces_its_gradients(port):
    """A 16 x 16 train cell, 8 microbatches: every gradient split over the
    data axis is reduce-scattered once a microbatch (the reduce-scatter is
    charged its input, the shard gathered back: ``fsdp_bytes``); under
    remat each layer's weights are gathered again for the recomputation;
    the gradients of the parameters no batch axis splits (the norms) are
    all-reduced in f32 once a step, among the step's other all-reduces;
    every group crosses nodes."""
    rec = port["prod_train"]
    assert rec["num_microbatches"] == 8
    ops = rec["collective_ops"]
    assert ops["_reduce_scatter_base_"] == 8 * rec["fsdp_bytes"]
    assert ops["_allgather_base_"] > 1.9 * ops["_reduce_scatter_base_"]
    assert rec["replicated"] and ops["allreduce_"] > 2 * sum(rec["replicated"])
    assert rec["collective_bytes"] == sum(ops.values())
    assert set(rec["links"]) == {"net"}
    assert rec["tokens"] == [16, 4096]
    assert rec["memory"]["total_bytes"] > rec["memory"]["argument_bytes"] > 0


def test_two_by_two_mesh_records_its_all_reduce(port):
    """A 2 x 2 cell (smoke llama3.2-1b, no remat, 2 microbatches): each
    FSDP shard is gathered once a microbatch and its gradient
    reduce-scattered once, so both move the sum of the gathered shards
    twice; the tensor-parallel pairs all-reduce."""
    rec = port["mesh_2x2"]
    assert rec["collective_ops"]["allreduce_"] > 0
    assert rec["collective_ops"]["_allgather_base_"] == 2 * rec["fsdp_bytes"] > 0
    assert rec["collective_ops"]["_reduce_scatter_base_"] == 2 * rec["fsdp_bytes"]
    assert set(rec["links"]) == {"nvlink"}  # ranks 0-3: one node


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "rules", "status", "tag", "cfg_overrides",
            "num_microbatches", "lower_s", "compile_s", "memory", "hlo_flops", "hlo_bytes",
            "collective_bytes", "collective_ops", "unresolved_whiles", "roofline",
            "roofline_kernel_adj", "model_flops", "model_flops_per_chip",
            "useful_compute_ratio", "trip_hints", "n_chips"}


def test_cli_writes_a_record_with_the_references_keys(tmp_path):
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape",
                "decode_32k", "--out", str(tmp_path), "--save-ops"])
    assert "done: 1 ok, 0 skipped, 0 errors" in out
    rec = json.loads((tmp_path / "llama3_2-1b_decode_32k_16x16.json").read_text())
    assert REF_KEYS <= set(rec) and rec["status"] == "ok"
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                  "total_bytes", "hbm_fraction"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                    "bound_s"}
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0 and rec["roofline"]["bound_s"] > 0
    assert rec["fits"] is True and rec["n_chips"] == 256 and rec["flop_counter"]["flops"] > 0
    assert (tmp_path / "llama3_2-1b_decode_32k_16x16.ops.tsv.gz").exists()
