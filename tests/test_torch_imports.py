"""The port stands alone: importing ``repro_torch``, running queries (BAS,
the cascade, a baseline), scoring pairs with the Oracle model, an MoE
forward and an encoder-decoder decode step, building,
saving, loading, appending to and querying through a stratification index,
serving queries through the oracle service (with its label store and
metrics exporter) and over its TCP transport, training (a train step,
a checkpoint, the training launcher, the autotuner's cache) and the mesh
layer (a data-parallel step and a sharded step in a world of one gloo
rank, the parameters' shardings, a scorer over the host mesh), the roofline and the dry run (one
cell traced on meta tensors in a fake world of 256 ranks)
load neither JAX nor the reference package, and its entry points run on
the card unless the caller asks for the CPU.  On CUDA tensors no op
returns a result without a gradient where an input requires one: the scan
kernels, which have no backward yet, raise."""
import os
import subprocess
import sys

import pytest
import torch

SCRIPT = r"""
import os
import sys
import repro_torch
from repro_torch.core import Agg, Catalog, JoinMLEngine, Query, Table, run_auto
from repro_torch.core.oracle import ArrayOracle
from repro_torch.core.types import BASConfig
from repro_torch.data import make_chain_dataset, make_clustered_tables

ds = make_clustered_tables(120, 110, n_entities=60, seed=3)
cat = Catalog()
cat.register(Table("a", ds.emb1, ds.columns1))
cat.register(Table("b", ds.emb2, ds.columns2))
cfg = BASConfig(max_dense_weight_bytes=0, n_bootstrap=100)
eng = JoinMLEngine(cat, lambda nl, names: ArrayOracle(ds.truth), cfg=cfg,
                   device="cpu")
res = eng.execute("SELECT SUM(a.value) FROM a JOIN b ON NL('x') "
                  "ORACLE BUDGET 600 WITH PROBABILITY 0.9")
assert res.telemetry.dispatch.path == "streaming"
res = eng.execute("SELECT COUNT(*) FROM a JOIN b ON NL('x') ORACLE BUDGET 600",
                  method="bas-cascade")
assert res.telemetry.cascade.proxy_rows > 0
res = eng.execute("SELECT COUNT(*) FROM a JOIN b ON NL('x') ORACLE BUDGET 600",
                  method="abae")
assert res.telemetry.mode == "abae"
ch = make_chain_dataset([12, 14, 16], seed=1)
run_auto(Query(spec=ch.spec(), agg=Agg.COUNT, oracle=ch.oracle(), budget=300),
         cfg, device="cpu")
from repro_torch.configs import get_smoke_config
from repro_torch.core import ModelOracle
from repro_torch.data.pipeline import ByteTokenizer, pair_example
from repro_torch.models import forward, init_params
from repro_torch.serve import PairScorer

tok = ByteTokenizer()
mcfg = get_smoke_config("joinml-oracle", vocab_size=tok.vocab_size)
recs = [f"acme unit {i}" for i in range(120)]

def tok_pair(pair):
    t, _ = pair_example(tok, recs[pair[0]], recs[pair[1] % 120], None, 48)
    return t[t != tok.PAD]

scorer = PairScorer(mcfg, init_params(mcfg, device="cpu"), tok_pair, tok.YES,
                    tok.NO, max_len=48, batch_size=16, device="cpu")
run_auto(Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ModelOracle(scorer),
               budget=200), cfg, device="cpu")
assert scorer.pairs_scored > 0
for arch in ("rwkv6-1.6b", "recurrentgemma-9b", "olmoe-1b-7b"):
    c = get_smoke_config(arch)
    forward(c, init_params(c, device="cpu"), {"tokens": [[1, 2, 3]]})
from repro_torch.models import decode_step, init_cache

c = get_smoke_config("whisper-medium")
p = init_params(c, device="cpu")
decode_step(c, p, init_cache(c, 1, 4, device="cpu"), [[1]], 0)
import tempfile
from repro_torch.checkpoint.index_io import load_index, save_index
from repro_torch.core import IndexStore, append_rows, build_index

with tempfile.TemporaryDirectory() as root:
    art = build_index([ds.emb1, ds.emb2[:100]], device="cpu")
    save_index(root, art)
    art = append_rows(load_index(root, art.key), 1, ds.emb2[100:], device="cpu")
    save_index(root, art)
    store = IndexStore(root=root, device="cpu")
    eng = JoinMLEngine(cat, lambda nl, names: ArrayOracle(ds.truth), cfg=cfg,
                       index_store=store, device="cpu")
    sql = "SELECT COUNT(*) FROM a JOIN b ON NL('x') ORACLE BUDGET 300"
    eng.execute(sql, method="bas-streaming")
    res = eng.execute(sql)
    assert res.telemetry.dispatch.path == "streaming-index"
    assert store.stats()["index_load"] == 1 and store.stats()["index_build"] == 0
from repro_torch.obs import MetricsExporter
from repro_torch.serve import (LabelStore, OracleService, OracleServiceServer,
                               RemoteOracle)

served = ArrayOracle(ds.truth)
with OracleService(max_wait_ms=60_000, label_store=LabelStore()) as svc:
    svc.attach(served)
    run_auto(Query(spec=ds.spec(), agg=Agg.COUNT, oracle=served, budget=300),
             cfg, device="cpu")
    svc.detach(served)
    assert svc.stats()["windows"] > 0 and served.charged > 0
    with MetricsExporter([svc.snapshot]) as exp:
        assert "repro_service_windows" in exp.render()
with OracleServiceServer({"truth": ArrayOracle(ds.truth)._label},
                         max_wait_ms=60_000) as srv:
    with RemoteOracle(srv.address, "truth", timeout_s=60, retries=0) as ro:
        run_auto(Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ro, budget=300),
                 cfg, device="cpu")
    assert srv.service.stats()["rows_labelled"] == ro.calls > 0
from repro_torch.checkpoint.checkpoint import restore_latest
from repro_torch.kernels import autotune
from repro_torch.launch.train import main as train_main
from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

tp = init_params(mcfg, device="cpu")
tp, to, tm = make_train_step(mcfg, OptimizerConfig(warmup_steps=1))(
    tp, init_opt_state(tp), {"tokens": [[1, 2, 3, 4, 5]]})
assert float(tm["loss"]) > 0
with tempfile.TemporaryDirectory() as d:
    autotune.configure(os.path.join(d, "autotune.json"))
    assert autotune.schedule("sim_sweep", 64, 64, 8, device="cpu") is None
    autotune.reset()
    train_main(["--steps", "2", "--batch", "2", "--seq", "8", "--ckpt", d,
                "--device", "cpu"])
    assert restore_latest(d, {"params": tp, "opt": to})[1]["step"] == 2
import datetime
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.sharding import TRAIN_RULES
from repro_torch.models.partition import param_shardings
from repro_torch.train.manual_dp import make_manual_dp_train_step

with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh((1,), ("data",), device="cpu")
    dp = make_manual_dp_train_step(mcfg, mesh, OptimizerConfig(grad_compression="int8"))
    tp, to, tm = dp(tp, to, {"tokens": [[1, 2, 3, 4, 5]]})
    assert float(tm["loss"]) > 0 and dp.wire["sum int32"] > 0
    param_shardings(tp, mesh, TRAIN_RULES)
    from repro_torch.launch.sharding import sharding_context
    from repro_torch.models.partition import shard_params

    sp = shard_params(init_params(mcfg, device="cpu"), mesh, TRAIN_RULES)
    with sharding_context(mesh, TRAIN_RULES):
        sp, so, sm = make_train_step(mcfg, OptimizerConfig(warmup_steps=1), 2)(
            sp, init_opt_state(sp), {"tokens": [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]})
    assert float(sm["loss"]) > 0 and int(so["step"]) == 1
    from repro_torch.launch.sharding import DECODE_RULES

    m2 = make_mesh((1, 1), ("data", "model"), device="cpu")
    sp = shard_params(init_params(mcfg, device="cpu"), m2, DECODE_RULES)
    with sharding_context(m2, DECODE_RULES):
        decode_step(mcfg, sp, init_cache(mcfg, 2, 8, mesh=m2, rules=DECODE_RULES),
                    [[1], [2]], 0)
    dist.destroy_process_group()
PairScorer(mcfg, tp, tok_pair, tok.YES, tok.NO, max_len=48, batch_size=16,
           mesh=make_host_mesh(device="cpu"), device="cpu").score([[1, 2], [3, 4]])
import repro_torch.roofline
from repro_torch.launch.dryrun import run_cell

with tempfile.TemporaryDirectory() as d:
    rec = run_cell("llama3.2-1b", "decode_32k", False, d)
    assert rec["status"] == "ok" and rec["hlo_flops"] > 0, rec
for name in ("repro_torch.train", "repro_torch.checkpoint.checkpoint",
             "repro_torch.runtime.fault_tolerance", "repro_torch.kernels.autotune",
             "repro_torch.launch.train", "repro_torch.launch.mesh",
             "repro_torch.launch.sharding", "repro_torch.models.partition",
             "repro_torch.train.manual_dp", "repro_torch.train.sharded",
             "repro_torch.roofline",
             "repro_torch.roofline.trace_analysis", "repro_torch.launch.cells",
             "repro_torch.launch.dryrun"):
    assert name in sys.modules, name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_entry_points_default_to_the_card():
    _no_card()
    from repro_torch.core import Agg, Catalog, JoinMLEngine, Query, run_auto
    from repro_torch.core import run_bas, run_bas_streaming
    from repro_torch.core import (run_abae, run_bas_cascade, run_bas_selection,
                                  run_blazeit, run_blocking, run_uniform, run_wwj)
    from repro_torch.core.similarity import pair_weights
    from repro_torch.core.stratify import stratify_streaming
    from repro_torch.core.types import BASConfig
    from repro_torch.data import make_clustered_tables
    from repro_torch.kernels.sim_hist import sim_hist
    from repro_torch.kernels.sim_sweep import prepare_right, sim_sweep
    from repro_torch.kernels.sim_topk import sim_topk
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import params_from_jax
    from repro_torch.models import init_cache, init_params
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.serve import ContinuousBatcher, PairScorer

    ds = make_clustered_tables(40, 30, seed=0)
    mcfg = get_smoke_config("joinml-oracle")
    cpu_params = init_params(mcfg, device="cpu")

    def q():
        return Query(spec=ds.spec(), agg=Agg.COUNT, oracle=ds.oracle(), budget=200)

    calls = [
        lambda: run_auto(q()),
        lambda: run_bas(q()),
        lambda: run_bas_streaming(q()),
        lambda: JoinMLEngine(Catalog(), lambda nl, names: None),
        lambda: JoinMLEngine(Catalog(), lambda nl, names: None,
                             proxy_factory=lambda nl, names: None),
        lambda: run_uniform(q()),
        lambda: run_wwj(q()),
        lambda: run_blocking(q(), 0.5),
        lambda: run_abae(q()),
        lambda: run_blazeit(q()),
        lambda: run_bas_cascade(q()),
        lambda: run_bas_selection(q(), 0.9),
        lambda: stratify_streaming(ds.emb1, ds.emb2, 0.2, 200, BASConfig(),
                                   use_kernel=True),
        lambda: pair_weights(ds.emb1, ds.emb2),
        lambda: sim_sweep(ds.emb1, ds.emb2),
        lambda: prepare_right(ds.emb2),
        lambda: sim_topk(ds.emb1, ds.emb2),
        lambda: sim_hist(ds.emb1, ds.emb2),
        lambda: init_params(mcfg),
        lambda: init_cache(mcfg, 2, 8),
        lambda: params_from_jax(mcfg, {}),
        lambda: PairScorer(mcfg, cpu_params, None, 5, 6),
        lambda: ContinuousBatcher(mcfg, cpu_params),
        lambda: serve_main(["--mode", "service"]),
        lambda: serve_main(["--mode", "server", "--port", "0"]),
        lambda: serve_main(["--mode", "worker", "--port", "0"]),
        lambda: serve_main(["--mode", "client"]),
        lambda: train_main(["--steps", "1"]),
        lambda: train_main(["--steps", "1", "--full-width"]),
        lambda: make_host_mesh(),
        lambda: make_mesh((1,), ("data",)),
        lambda: serve_main(["--mode", "score", "--shard"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


def test_scan_kernels_refuse_to_drop_a_gradient():
    """K6 and K7 carry gradients on CUDA tensors: under autograd the ops are
    their ``torch.autograd.Function``s, whose backwards launch the backward
    kernels, so gradients reach r, k, v, w, u, a and g; without autograd
    the launch is the forward alone, the one serving makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    dev = torch.device("cuda")
    r, k, v = (torch.randn(1, 2, 4, 16, device=dev, requires_grad=True) for _ in range(3))
    w = torch.rand(1, 2, 4, 16, device=dev, requires_grad=True)
    u = torch.randn(2, 16, device=dev, requires_grad=True)
    a = torch.rand(1, 4, 32, device=dev, requires_grad=True)
    g = torch.randn(1, 4, 32, device=dev, requires_grad=True)
    cuda_lib.reset_launches()
    grads = torch.autograd.grad(rwkv6_scan(r, k, v, w, u).sum() + rglru_scan(a, g).sum(),
                                (r, k, v, w, u, a, g))
    assert all(x is not None and torch.isfinite(x).all() for x in grads)
    assert {n: c for n, c in cuda_lib.LAUNCHES.items() if c} == {
        "rwkv6_scan": 1, "rwkv6_scan_bwd": 1, "rglru_scan": 1, "rglru_scan_bwd": 1}
    cuda_lib.reset_launches()
    with torch.no_grad():
        assert rglru_scan(a, g).grad_fn is None
        assert rwkv6_scan(r, k, v, w, u).shape == (1, 2, 4, 16)
    assert {n: c for n, c in cuda_lib.LAUNCHES.items() if c} == {
        "rwkv6_scan": 1, "rglru_scan": 1}


def test_plain_ops_keep_the_gradient_on_the_cpu():
    """On CPU tensors the three model ops run their plain versions, which
    autograd differentiates (K5's CUDA backward: tests/test_torch_cuda.py)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    q = torch.randn(1, 2, 5, 16, requires_grad=True)
    w = torch.rand(1, 2, 5, 16)
    for out in (flash_attention(q, q, q), rwkv6_scan(q, q, q, w, torch.randn(2, 16)),
                rglru_scan(torch.rand(1, 5, 16), q[0, :1])):
        assert out.grad_fn is not None
        (g,) = torch.autograd.grad(out.sum(), q)
        assert g.shape == q.shape and torch.isfinite(g).all()


def test_cuda_tensor_never_falls_back():
    """The kernel wrappers refuse CPU tensors instead of quietly running the
    plain version: only the ops choose, by the tensors' device."""
    from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda

    a = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sim_topk_cuda(a, a, k=2)


def test_tf32_is_off():
    from repro_torch.device import resolve_device

    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
