"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): ``model_flops`` on every (arch, shape) cell, the
report helpers on the same records, ``Cost``'s arithmetic, and each hand-
written kernel's work (``roofline.kernel_work``) against the bounds that
``PERF.md``'s kernel table prints, at the shapes it names, and
``CostMode``'s reuse of meta outputs against running every op.

The two ``hw`` modules hold different chips' constants (the port's the
H100's), so a roofline fraction is compared as fraction x peak.
"""
import json

import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.launch.cells import SHAPES as REF_SHAPES
from repro.roofline import hw as ref_hw
from repro.roofline import report as ref_report
from repro.roofline.hlo_analysis import Cost as RefCost
from repro_torch.configs import ARCHS, get_config
from repro_torch.roofline import hw, kernel_work, report
from repro_torch.roofline.trace_analysis import Cost


def test_archs_and_shapes_are_the_references():
    from repro_torch.launch.cells import SHAPES

    assert ARCHS == REF_ARCHS
    assert SHAPES == REF_SHAPES


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_model_flops_are_the_references(arch):
    for shape in REF_SHAPES.values():
        assert report.model_flops(get_config(arch), shape) == \
            ref_report.model_flops(ref_config(arch), shape)


def _records():
    """Records in the reference's layout: ok, skipped and error cells on
    both meshes, a tagged and a rule variant (which the table leaves out)."""
    def ok(arch, shape, mesh, i, **extra):
        return {"arch": arch, "shape": shape, "mesh": mesh, "rules": "default", "tag": "",
                "status": "ok",
                "roofline": {"compute_s": 1e-3 * i, "memory_s": 2e-3 / i,
                             "collective_s": 3e-4 * i, "dominant": "memory",
                             "bound_s": max(1e-3 * i, 2e-3 / i, 3e-4 * i)},
                "model_flops_per_chip": 1.5e12 * i, "useful_compute_ratio": 0.25 * i,
                "memory": {"total_bytes": 3 * 2**30 * i}, **extra}
    return [
        ok("llama3-8b", "train_4k", "16x16", 1),
        ok("llama3-8b", "decode_32k", "16x16", 2),
        ok("llama3-8b", "train_4k", "2x16x16", 3),
        ok("llama3-8b", "prefill_32k", "16x16", 4, tag="variant"),
        ok("llama3-8b", "prefill_32k", "16x16", 5, rules="TRAIN_RULES_SP"),
        {"arch": "llama3-8b", "shape": "long_500k", "mesh": "16x16", "rules": "default",
         "status": "skipped", "reason": "needs sub-quadratic attention"},
        {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "16x16", "rules": "default",
         "status": "error", "error": "boom"},
    ]


def test_report_helpers_give_the_references_output(tmp_path):
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    loaded = report.load_records(str(tmp_path))
    assert loaded == ref_report.load_records(str(tmp_path)) == recs
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(loaded, mesh) == ref_report.roofline_table(loaded, mesh)
    for r in loaded:
        ours = report.roofline_fraction(r) * hw.PEAK_FLOPS_BF16
        theirs = ref_report.roofline_fraction(r) * ref_hw.PEAK_FLOPS_BF16
        assert ours == pytest.approx(theirs, rel=1e-12)
    assert report.roofline_fraction(recs[0]) > 0 and report.roofline_fraction(recs[5]) == 0


def test_report_table_adds_the_fits_column():
    recs = _records()[:2]
    recs[0]["fits"], recs[1]["fits"] = True, False
    table = report.roofline_table(recs).splitlines()
    assert table[0].endswith("| fits |") and table[2].endswith("| yes |")
    assert table[3].endswith("| no |")


def test_cost_adds_and_scales_as_the_references():
    a = dict(flops=3.0, bytes=5.0, collective_bytes=7.0,
             collective_ops={"allreduce_": 7.0}, unresolved_whiles=["x"])
    b = dict(flops=1.5, bytes=2.0, collective_bytes=4.0,
             collective_ops={"allreduce_": 1.0, "allgather_": 3.0}, unresolved_whiles=[])
    ours = (Cost(**a) + Cost(**b)).scaled(2.5)
    theirs = (RefCost(**a) + RefCost(**b)).scaled(2.5)
    assert vars(ours) == vars(theirs)
    assert vars(Cost()) == vars(RefCost())


# (kernel, shape, the bound PERF.md's kernel table prints in ms, its "by")
PERF_BOUNDS = [
    ("sim_sweep", dict(m=32768, n=32768, d=384, precision="fp32"), "12.31", "operations"),
    ("sim_sweep", dict(m=32768, n=32768, d=384, precision="bf16"), "0.83", "operations"),
    ("sim_sweep", dict(m=32768, n=32768, d=384, precision="int8"), "0.42", "operations"),
    ("sim_topk", dict(m=32768, n=32768, d=384, k=32), "12.31", "operations"),
    ("sim_topk", dict(m=8, n=32768, d=384, k=128), "0.015", "bytes"),
    ("sim_hist", dict(m=32768, n=32768, d=384), "12.31", "operations"),
    ("flash_attention", dict(b=256, hq=12, hkv=12, sq=48, skv=48, d=64, causal=True),
     "0.0225", "bytes"),
    ("flash_attention_bwd", dict(b=16, hq=12, hkv=12, sq=128, skv=128, d=64, causal=True),
     "0.0075", "bytes"),
    ("rwkv6_scan", dict(b=256, h=32, t=48, hd=64), "0.120", "operations"),
    ("rwkv6_scan_bwd", dict(b=16, h=32, t=128, hd=64), "0.0561", "operations"),
    ("rwkv6_scan_bwd", dict(b=1, h=32, t=4096, hd=64), "0.1122", "operations"),
    ("rglru_scan", dict(b=256, t=48, r=4096), "0.180", "bytes"),
    ("rglru_scan_bwd", dict(b=8, t=128, r=4096), "0.0250", "bytes"),
    ("bootstrap", dict(draws=16 * 1000 * 1000, samples=16000, n_boot=1000), "0.00188",
     "operations"),
    ("bootstrap", dict(draws=16 * 1000 * 1000, samples=16000, n_boot=1000, arrays=2),
     "0.00471", "operations"),
]


@pytest.mark.parametrize("kernel,shape,printed,by", PERF_BOUNDS,
                         ids=[f"{k}-{i}" for i, (k, *_r) in enumerate(PERF_BOUNDS)])
def test_kernel_work_gives_perf_md_bounds(kernel, shape, printed, by):
    flops, byts, peak = kernel_work.work(kernel, **shape)
    ms = kernel_work.bound_ms(flops, byts, peak)
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed, ms
    assert kernel_work.bound_by(flops, byts, peak) == by


@pytest.mark.parametrize("sq,skv,causal,window", [
    (48, 48, True, 0), (304, 304, True, 0), (1500, 1500, False, 0), (48, 1500, False, 0),
    (4096, 4096, True, 2048), (100, 100, True, 7), (30, 50, True, 0), (50, 30, False, 9)])
def test_attention_pairs_counts_the_masks(sq, skv, causal, window):
    import numpy as np

    qp, kp = np.arange(sq)[:, None], np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= qp - kp < window
    assert kernel_work.attention_pairs(sq, skv, causal, window) == int(ok.sum())


def test_hw_holds_the_h100s_constants():
    assert (hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_BF16, hw.PEAK_OPS_INT8) == (67e12, 989e12,
                                                                         1979e12)
    assert hw.HBM_BW == 3.35e12 and 80e9 < hw.HBM_BYTES < 86e9
    assert hw.link_bw(range(8)) == hw.NVLINK_BW == 450e9
    assert hw.link_bw([0, 16, 32]) == hw.link_bw([7, 8]) == hw.NET_BW == 50e9


class _NoReuse(dict):
    """A ``CostMode`` cache that keeps nothing: every meta op runs."""

    def __setitem__(self, key, value):
        pass


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "recurrentgemma-9b"])
def test_cost_mode_reuse_counts_what_running_every_op_counts(arch):
    """``CostMode`` reuses a meta op's outputs for repeated metadata; a
    train step traced so counts the same FLOPs, bytes, launches and peak
    bytes as with every op run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.roofline.trace_analysis import CostMode, analyze
    from repro_torch.train import init_opt_state, make_train_step

    cfg = get_smoke_config(arch, remat=True)
    step = make_train_step(cfg)
    batch = {"tokens": torch.empty((2, 32), dtype=torch.int32, device="meta")}
    modes = []
    for reuse in (True, False):
        params = init_params(cfg, device="meta")
        opt = init_opt_state(params)
        mode = CostMode()
        if not reuse:
            mode._cache = _NoReuse()
        with mode:
            step(params, opt, batch)
        modes.append(mode)
    a, b = modes
    assert vars(a.cost) == vars(b.cost) and a.cost.flops > 0
    assert a.kernels == b.kernels and a.peak_bytes == b.peak_bytes > 0
    assert len(a._cache) > 0
    params = init_params(cfg, device="meta")
    assert vars(analyze(step, params, init_opt_state(params), batch)) == vars(a.cost)


# ----------------------------------------------------------------------------
# collectives on meta tensors over a fake world of 256 ranks
# ----------------------------------------------------------------------------

COLLECTIVES = r"""
import json
import torch
import torch.distributed as dist
from repro_torch.launch.dryrun import fake_world
from repro_torch.roofline.trace_analysis import CostMode


def m(n):
    return torch.empty(n, device="meta", dtype=torch.float32)


out = {}
with fake_world(256):
    groups = {"nvlink": list(range(8)), "net": list(range(16)), "local": [0]}
    for link, ranks in groups.items():
        g, n = dist.new_group(ranks), len(ranks)
        calls = {
            "allreduce_": lambda: dist.all_reduce(m(64), group=g),
            "_allgather_base_": lambda: dist.all_gather_into_tensor(m(64 * n), m(64), group=g),
            "allgather_": lambda: dist.all_gather([m(64) for _ in range(n)], m(64), group=g),
            "_reduce_scatter_base_": lambda: dist.reduce_scatter_tensor(m(64), m(64 * n),
                                                                        group=g),
            "reduce_scatter_": lambda: dist.reduce_scatter(m(64), [m(64) for _ in range(n)],
                                                           group=g),
            "alltoall_base_": lambda: dist.all_to_all_single(m(64 * n), m(64 * n), group=g),
            "broadcast_": lambda: dist.broadcast(m(64), src=0, group=g),
        }
        for name, fn in calls.items():
            with CostMode() as mode:
                fn()
            out[f"{link} {name}"] = {"ops": mode.cost.collective_ops,
                                     "bytes": mode.cost.collective_bytes,
                                     "links": dict(mode.links),
                                     "op_links": {k: dict(v) for k, v in mode.op_links.items()}}
print("RESULT " + json.dumps(out))
"""

# the bytes each op is charged for 64 f32 elements a rank over n ranks: the
# all-reduce 2 x its tensor, the all-gather its gathered output, the
# reduce-scatter its input (the reference's ``hlo_analysis`` rule), the
# all-to-all its output, the broadcast its tensor
CHARGED = {"allreduce_": lambda n: 2 * 256, "_allgather_base_": lambda n: 256 * n,
           "allgather_": lambda n: 256 * n, "_reduce_scatter_base_": lambda n: 256 * n,
           "reduce_scatter_": lambda n: 256 * n, "alltoall_base_": lambda n: 256 * n,
           "broadcast_": lambda n: 256}
GROUPS = {"nvlink": 8, "net": 16, "local": 1}


@pytest.fixture(scope="module")
def collectives():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", COLLECTIVES], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT ", 1)[1])


@pytest.mark.parametrize("link", sorted(GROUPS))
@pytest.mark.parametrize("op", sorted(CHARGED))
def test_collectives_are_charged_on_meta(collectives, op, link):
    """Each collective on meta tensors over a group of ranks 0-7 (one node:
    NVLink), 0-15 (two nodes: the network, ``hw.link_bw``) or rank 0 alone
    (no link): its bytes by the reference's rule, under its own name and
    link."""
    rec = collectives[f"{link} {op}"]
    want = float(CHARGED[op](GROUPS[link]))
    assert rec["ops"] == {op: want} and rec["bytes"] == want
    assert rec["links"] == {link: want} and rec["op_links"] == {op: {link: want}}
    if link != "local":
        ranks = range(GROUPS[link])
        assert (hw.link_bw(ranks) == hw.NVLINK_BW) == (link == "nvlink")


def test_collective_table_reads_each_op_by_its_schema():
    """Every op the table charges names its charged tensors and its process
    group by arguments of its own schema (the ops order them differently),
    the coalesced ones too, which have no meta kernel to run."""
    from repro_torch.roofline.trace_analysis import _COLLECTIVES

    assert "reduce_scatter_tensor_coalesced_" in _COLLECTIVES
    for name, (arg, factor) in _COLLECTIVES.items():
        schema = getattr(torch.ops.c10d, name).default._schema
        names = {a.name for a in schema.arguments}
        assert arg in names and "process_group" in names, name
        assert factor == (2.0 if name.startswith("allreduce") else 1.0)
