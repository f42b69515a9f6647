"""Drive the PyTorch + CUDA port end to end on one card: the query engine
with its similarity kernels, and the Oracle model stack with its kernels.

    python3 chip_smoke.py                 # the full run on a CUDA card
    python3 chip_smoke.py --rehearse-cpu  # tiny sizes, plain versions, CPU

Phases: (1) the card; (2) build the CUDA kernels from ``src/repro_torch/csrc``
(every source at once) and print ptxas's report; (3) hold every similarity
kernel against its plain PyTorch version at main-path shapes (a 4,096-row
slice of E1 against the full E2) under the rules of
``repro_torch.kernels.checks``, the fp32 and bf16 sweeps against their
two-pass kernels bit for bit (with the largest bf16 score error over its
bound), the int8 sweep against its plain version bit for bit, the top-k of
``HOT_ROWS`` rows at k 128 (the few-row kernels) against the fp32 sweep's
lists, and the fp32 sweep as the 3-way chain calls it (exponent 0.5, a
per-row scale, walk sums at exponent 1); then flash attention and the two
recurrent scans against theirs at the shapes the model paths give them and
at one long shape each, with their times (the RWKV6 scan in the model's
layout and types, and on f32 operands); (3c) the backward kernels
against an f64 autograd of their plain versions, bit for bit on a second
run: K5's under ``checks.flash_attention_grad_bound`` at the training
shape (bf16 and f32) and at the other families' attention shapes
(recurrentgemma's training MQA among them), beside SDPA's forward and
backward; K6's at rwkv6-1.6b's training shape (bf16 r, k, v in the model's
layout) and K7's at recurrentgemma-9b's, under ``checks.*_scan_grad_bound``;
(3d) K8, the bootstrap-t's resampling, against its plain NumPy version at
the labels cell's shape (16 strata x 1,000 samples, 1,000 resamples; COUNT
and AVG): the same draws, the Generator's state after, the moments within
1e-10, bit for bit twice; its kernels' device time and the whole call's;
(4) the query path:
``JoinMLEngine.execute`` on 32,768 x 32,768 records at d = 384 (COUNT, SUM,
AVG; COUNT at bf16, at int8 and on the two-pass schedule; a catalog with
canonical records that drives the raised-k top-k retry), a 3-way chain
through ``run_auto`` and a small dense-routed query, with launch counts read
around the whole phase; (4b) the other query methods: the multi-fidelity
cascade (``execute(method="bas-cascade")``, COUNT, SUM, AVG and a two-pass
COUNT, with the similarity proxy, and ``run_auto`` with ``cfg.cascade``),
WWJ's walks and uniform sampling on phase 4's tables; ABAE, BlazeIt,
blocking (its threshold calibrated on a validation split) and selection on
4,096 x 8,192 records, the largest the dense path admits; the cascade on
phase 6's Oracle path; each method on the card against the CPU on phase 4's
small tables; (4c) the
persistent stratification index on phase 4's tables: the fp32 index built
through an ``IndexStore``, saved, and mmap-loaded into a new store; COUNT,
SUM, AVG, the hot-row COUNT (the k 128 retry over the live embeddings), a
cascade COUNT and the 3-way chain through ``JoinMLEngine(index_store=...)``
/ ``run_auto``, each equal to its phase 4 / 4b run bit for bit and
launching no sweep; one profiled warm COUNT; appends against rebuilds on
the card (fp32 right then left, int8 and bf16 right, and an artifact with
32-row count tiles, also against the CPU), each append and rebuild
profiled once for its device time; the sweep kernel against its plain
version at the appends' shapes (a right append's delta at each precision,
a left append's chunk); and the launcher's ``build-index`` and
``refresh-index`` modes; then one profiled COUNT on phase 4's tables, and
one profiled cascade COUNT and WWJ COUNT (after 4c's profiles: after a
session of many events the profiler loses some of a later session's
device events); (5) the
similarity kernels' times with CUDA events
at the phase-4 shapes (and, for context, ``torch.matmul`` and
``torch._int_mm`` of the bare fp32 and int8 products); (6) the Oracle path:
a COUNT join of two 256-record tables whose Oracle is the full
``joinml-oracle`` (12 layers, d 768, bf16, random weights from a seed)
behind ``PairScorer`` and ``ModelOracle``, held against every pair scored
by the same scorer, then profiled; (7) the
scorer on the card against the CPU (joinml-oracle, a block of each
recurrent model, one layer of olmoe-1b-7b and of qwen3-moe-235b-a22b at
full width with their routes compared, and whisper-medium's forward at one
encoder and one decoder layer over 1,500 frames); (8) the recurrent paths:
``rwkv6-1.6b`` at full size and ``recurrentgemma-9b`` at full width cut to
8 layers score 2,048 pairs each; (9) the MoE, VLM and encoder-decoder
families, one model on the card at a time: the full ``olmoe-1b-7b`` as the
Oracle of phase 6's COUNT (held by phase 6's checks), scoring 2,048 pairs,
the same batch twice (bit for bit), 16,384 of the truth's pairs again in
another batch order (the labels that move are reported: capacity counts
every token of a batch), and 4 requests through ``ContinuousBatcher``;
``qwen3-moe-235b-a22b`` at full width cut to 4 of 94 layers and the full
``pixtral-12b`` scoring 2,048 pairs each; pixtral's forward over 256
seeded patches before a 48-token prompt, batch 4; and the full
``whisper-medium``'s forward over (4, 1,500) seeded frames and a 48-token
prompt, then 16 decode steps; and (9e) the full ``moonlight-16b-a3b``
(latent attention through K5 at q/k 192 against v 128, dropless experts)
scoring 2,048 pairs.  Flash attention is also checked and timed at those
models' shapes (phase 3), the latent widths in a row of their own; (10) the serving plane: (10a) eight
concurrent BaS COUNT queries (seeds 0-7) whose Oracle is phase 6's
(``ModelOracle(..., name="joinml-oracle")``) through one ``OracleService``
with a ``LabelStore``, each equal to its serial run bit for bit, the summed
charge equal to the store's unique misses, then the store saved at close
serving two of the queries through a restarted service with no backend
row; (10b) the launcher's ``worker`` and ``server`` modes as subprocesses
on 127.0.0.1 serving that Oracle (port 0, the bound addresses read from
their output), four ``RemoteOracle`` queries equal to 10a's serial runs,
the front's remote shards read from one scrape of ``--metrics-port``, the
``client`` and ``service`` modes run to their end, and the server killed
between two flushes of one query and restarted on its port, the query
charged once; (10c, run after 4c while phase 4's tables are resident) four
concurrent ``run_auto`` COUNTs through one
``OracleService(index_store=IndexStore(...))``: one fp32 build sweep,
three index hits, each estimate equal to 4c's warm COUNT; (11) training:
the full ``joinml-oracle`` (remat on, AdamW) on a repeated batch of 16 x
128 pair tokens from the entity corpus, the loss finite and falling, its
median step, tokens/s, peak memory, K5's launches a step and the device's
idle share over 3 profiled steps; 4 microbatches against 1; 3 steps, a
save through ``AsyncCheckpointer``, a restore and 3 more steps against 6
uninterrupted ones, bit for bit, in a subprocess under
``torch.use_deterministic_algorithms``; and the training launcher started
twice on one checkpoint directory, the second start resuming; (11b) the
recurrent families, one model on the card at a time: the full
``rwkv6-1.6b`` (16 x 128 tokens) and ``recurrentgemma-9b`` at full width
cut to 8 layers (8 x 128), remat on, 6 steps each on a repeated batch, the
loss finite and falling, the exact launches a step of K6, K7, K5 and their
backward kernels, the median step, tokens/s, peak memory and idle share.
The launcher check also runs ``--arch rwkv6-1.6b`` for two steps.  (12) The
mesh: (12a) ``train.manual_dp.make_manual_dp_train_step`` on phase 11's
model and batch, 2 steps in each of the none and int8 all-reduces, at world
2 (two processes on the one card over gloo with CUDA tensors: NCCL refuses
two ranks on one device) and at world 1 (NCCL, in this process): each
rank's step ms, all-reduce ms, peak memory and exactly 24 + 12 K5 launches
a step, int8's gradients summed as int32, and the world of 2's first step
against the one-process step within the trainer's bf16 rule; (12c) the
checkpoint rank 0 of the world of 2 saved, restored in the world of 1 as
DTensors on ``param_shardings``, every leaf bit for bit; (12b)
``PairScorer(mesh=make_host_mesh())`` over every pair of phase 6's tables
against the unsharded scorer bit for bit, and ``launch/serve.py --mode
score --shard`` as a subprocess.  (13) The dry run and the roofline:
(13a) ``python -m repro_torch.launch.dryrun --all --both-meshes`` as a
subprocess (a worker process a core, up to 8): 80 records, 64 ok and 16
skipped, each ok record with its FLOPs, bytes, bound and ``fits``, every
train record with its all-reduce; the 16 x 16 roofline table; a cell
whose rank does not fit the card fails the phase; (13b) phase 11's step as a 1 x 1-mesh
cell traced on meta tensors in a subprocess of its own (phase 12a's NCCL
world holds this process): its charged launches equal phase 11's a step,
and phase 11's median step may not be shorter than its roofline bound (the
step's share of the bound is printed); (13c) the four
``examples/*_torch.py`` on the card, each exiting 0.  (14) The sharded
train step (phase 11's model at f32, 8 microbatches) at world 1 over NCCL
and world 2 (two gloo processes on the card), against the one-process
step.  (15) Sharded serving on the same worlds: the prefill of phase 14's
batch under ``SERVE_RULES`` and 24 decode steps into 32 slots under
``DECODE_RULES`` (the cache's slots over "model"), and the full
whisper-medium's 8 decode steps over 1,536 frames split over "model" on
1 x 2, each world's logits against the one-process run (bit for bit on 1
x 1, else within 2e-5 of the largest |logit|), K5's launches a prefill,
step and collective ms and peak memory.  Every bound the
script prints is ``repro_torch.roofline.kernel_work``'s.  Phases 3 to
4c and 10c run with the launch autotuner on (``kernels.autotune``, its
cache measured afresh under ``build/``; its entries and measuring seconds
are printed apart from the timed queries); it is off again from phase 5,
and the Oracle COUNT (6) and the served COUNTs (10a) must equal the
estimates recorded before this run's changes bit for bit.  Launch counts
are set to 0 just before each path (4; 4b's query path, dense baselines
and Oracle cascade; 6; 8; each of 9's, where olmoe's path is the COUNT's
``execute`` and its timed scoring and batcher are counted apart; 10a's
served queries; 10c's queries; 11's steps; each of 11b's; each of 12a's
steps in each rank; 12b's sharded scoring; 14's steps and 15's prefills
and decodes in each rank; 10b's launches happen in its subprocesses)
and read just after it; in 4c, just before each of the index
path's own calls (its builds, queries and appends, not the rebuilds and
kernel checks they are held against) and read just after it.

Any failed phase exits non-zero.  The last lines are one JSON object of
kernels, the card's name and power limit, and ``{"ok": true, ...}``.
Without a card (or without the repository beside it) it exits non-zero and
prints no result.  The rehearsal runs phases 4, 4b, 4c, 6, 7, 8, 9, 10,
11, 12, 13 (13a on one cell), 14 and 15 at a tiny size on the CPU and
exits 3.
"""
import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIM_SOURCE = "src/repro_torch/csrc/sim_kernels.cu"
MODEL_SOURCE = "src/repro_torch/csrc/model_kernels.cu"
REPLACES = {
    "sim_sweep[fp32]": "src/repro/kernels/sim_sweep/kernel.py:150",
    "sim_sweep[bf16]": "src/repro/kernels/sim_sweep/kernel.py:150",
    "sim_sweep_q[int8]": "src/repro/kernels/sim_sweep/kernel.py:167",
    "sim_topk[k=32]": "src/repro/kernels/sim_topk/kernel.py:23",
    "sim_topk[k=128]": "src/repro/kernels/sim_topk/kernel.py:23",
    "sim_hist": "src/repro/kernels/sim_hist/kernel.py:34",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:21",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:26",
    "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:24",
    # K5 at latent attention's widths: the same kernel (the reference has no
    # latent attention), launched as flash_attention_bf16_kernel<192, 128>
    "flash_attention_192_128": "src/repro/kernels/flash_attention/kernel.py:21",
}
SIM_KERNELS = tuple(REPLACES)[:6]
MODEL_KERNELS = tuple(REPLACES)[6:]
LATENT = "flash_attention_192_128"
# the path whose launches a model kernel's row counts
MAIN_PATH = {"flash_attention": "Oracle COUNT", "rwkv6_scan": "rwkv6-1.6b",
             "rglru_scan": "recurrentgemma-9b", LATENT: "moonlight-16b-a3b (9)"}
# K5's backward has no Pallas counterpart: the reference differentiates its
# jnp attention
BWD_REPLACES = ("src/repro/models/layers.py:157 (jax.grad of chunked_attention; "
                "no Pallas kernel)")
# nor have the scans' backwards: the reference differentiates its lax.scans
SCAN_BWD_REPLACES = {
    "rwkv6_scan_bwd": "src/repro/models/recurrent.py:103 (jax.grad of the RWKV6 lax.scan; "
                      "no Pallas kernel)",
    "rglru_scan_bwd": "src/repro/models/recurrent.py:212 (jax.grad of the RG-LRU lax.scan; "
                      "no Pallas kernel)",
}
# every bound printed here is ``repro_torch.roofline.kernel_work``'s: the
# kernel's work at its shape against the H100's peaks and HBM rate
# (``roofline.hw``), the definition the dry run charges launches with


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


@dataclasses.dataclass(frozen=True)
class Size:
    n: int          # records per table of the main catalog
    d: int          # embedding width
    slice: int      # rows of E1 that phase 3 holds against all of E2
    budget: int     # oracle budget of a query
    dense_cap: int  # BASConfig.max_dense_weight_bytes
    dense: tuple    # records per table of phase 4b's dense baselines


# the main path: two tables of 32,768 records at the embedder's width; the
# dense baselines at 4,096 x 8,192 pairs, the 256 MiB of f64 weights that the
# default max_dense_weight_bytes admits
FULL = Size(n=32768, d=384, slice=4096, budget=20000, dense_cap=256 * 2**20,
            dense=(4096, 8192))
# the CPU rehearsal: the same phases at a size the CPU runs in seconds
REHEARSAL = Size(n=1024, d=64, slice=256, budget=4000, dense_cap=2**16,
                 dense=(128, 256))
SEED = 0
HOT_ROWS = 8  # canonical records of the hot catalog: the rows the k = 128 retry takes


@dataclasses.dataclass(frozen=True)
class ModelSize:
    full: bool            # the configs at full width (else the reduced ones)
    entities: int         # entities of the corpus, 8 records each, split in two tables
    batch: int            # PairScorer batch size
    budget: int           # the Oracle query's budget
    sample: int           # pairs whose P(match) sets the threshold
    cpu_pairs: int        # joinml-oracle pairs scored on the card and on the CPU
    recurrent_pairs: int  # pairs each recurrent model scores
    family_pairs: int     # pairs each model of phase 9 scores
    order_pairs: int      # truth pairs olmoe scores again in another batch order
    family_batch: int     # phase 9's forwards: rows of patches or frames
    decode_steps: int     # whisper's decode steps after its forward


# the Oracle paths: two tables of 256 records (65,536 pairs), batches of 256
FULL_MODEL = ModelSize(full=True, entities=64, batch=256, budget=2000,
                       sample=4096, cpu_pairs=64, recurrent_pairs=2048,
                       family_pairs=2048, order_pairs=16384, family_batch=4,
                       decode_steps=16)
REHEARSAL_MODEL = ModelSize(full=False, entities=8, batch=16, budget=300,
                            sample=256, cpu_pairs=8, recurrent_pairs=32,
                            family_pairs=32, order_pairs=256, family_batch=2,
                            decode_steps=4)
RGEMMA_LAYERS = 8      # two (rec, rec, attn) blocks and a 2-layer rec tail
QWEN3_LAYERS = 4       # of 94: the whole model does not fit on one 80 GB card
PROMPT = 48            # phase 9's prompt tokens: the scorer's 48-token bucket
EMBED_D = 384          # the embedder's width
THRESHOLD_Q = 0.95     # the Oracle says yes to the top 5% of P(match)
# P(match) on the card against the CPU, both in bf16 (and whisper's logits,
# relative to the largest): the two sides round matmul sums to bf16 in
# other orders, layer after layer
CARD_CPU_ATOL = 0.02
MOE_CPU_PAIRS = 8      # phase 7's MoE pairs: 384 tokens, 60 (olmoe) / 30 (qwen3) slots an expert


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def make_catalogs(n, d, seed):
    from repro_torch.core import Catalog, Table
    from repro_torch.data import make_clustered_tables

    ds = make_clustered_tables(n, n, d=d, n_entities=512, noise=0.35, seed=seed)
    main = Catalog()
    main.register(Table("a", ds.emb1, ds.columns1))
    main.register(Table("b", ds.emb2, ds.columns2))
    hot = make_hot(n, d, seed)
    hcat = Catalog()
    hcat.register(Table("h", hot.emb1, hot.columns1))
    hcat.register(Table("b", hot.emb2, hot.columns2))
    return ds, main, hot, hcat


def make_hot(n, d, seed):
    """The hot catalog's tables: the first ``HOT_ROWS`` left records are
    canonical descriptions of their entity (the mean of its right records),
    so those rows clear the top-m threshold with far more than 32 partners,
    which drives the raised-k top-k retry of the collection."""
    from repro_torch.core.similarity import normalize
    from repro_torch.data import make_clustered_tables

    hot = make_clustered_tables(max(n // 8, 64), n, d=d, n_entities=max(n // 512, 2),
                                noise=0.35, seed=seed + 1)
    e1 = hot.emb1.copy()
    for i in range(HOT_ROWS):
        e1[i] = normalize(hot.emb2[hot.truth[i] > 0].mean(axis=0, keepdims=True))[0]
    return dataclasses.replace(hot, emb1=e1)


def retry_operands(hot, rows):
    """The raised-k retry's operands as ``sim_topk`` pads them: the first
    ``rows`` hot rows (padded with zero rows to a multiple of 8) and the
    full right table, on the card in f32."""
    h1 = torch.from_numpy(hot.emb1[:rows]).cuda()
    return (torch.nn.functional.pad(h1, (0, 0, 0, (-rows) % 8)),
            torch.from_numpy(hot.emb2).cuda())


def make_small(size):
    """Phase 4's small tables: 1,024 x 1,024 records at the full size."""
    from repro_torch.data import make_clustered_tables

    m = max(size.n // 32, 64)
    return make_clustered_tables(m, m, d=size.d, n_entities=128, noise=0.35,
                                 seed=SEED + 3)


def make_chain(size):
    """The 3-way chain of phase 4: 64 x 512 x 32,768 at the full size."""
    from repro_torch.data import make_chain_dataset

    n = size.n
    return make_chain_dataset([max(n // 512, 4), max(n // 64, 8), n], d=size.d,
                              n_entities=256, noise=0.3, seed=SEED + 2)


def run_phase4(size, device, launches):
    from repro_torch.core import Agg, JoinMLEngine, Query, run_auto
    from repro_torch.core import similarity
    from repro_torch.core.oracle import ArrayOracle
    from repro_torch.core.types import BASConfig
    from repro_torch.data import make_clustered_tables

    n, d, budget = size.n, size.d, size.budget
    t0 = time.perf_counter()
    ds, main, hot, hcat = make_catalogs(n, d, SEED)
    chain = make_chain(size)
    small = make_small(size)
    log(f"data: {time.perf_counter() - t0:.1f} s")

    row_t = ds.truth.sum(axis=1, dtype=np.int64)
    col_t = ds.truth.sum(axis=0, dtype=np.int64)
    count = float(row_t.sum())
    truths = {
        "count": count,
        "sum": float(ds.columns1["value"] @ row_t),
        "avg": float(ds.columns2["value"] @ col_t) / count,
    }
    sql = {
        "count": "SELECT COUNT(*) FROM a JOIN b ON NL('same entity') "
                 f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
        "sum": "SELECT SUM(a.value) FROM a JOIN b ON NL('same entity') "
               f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
        "avg": "SELECT AVG(b.value) FROM a JOIN b ON NL('same entity') "
               f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
        "hot": "SELECT COUNT(*) FROM h JOIN b ON NL('same entity') "
               f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
    }
    oracle = lambda nl, names: ArrayOracle(ds.truth)  # noqa: E731
    cfg = BASConfig(max_dense_weight_bytes=size.dense_cap)
    runs = [
        ("COUNT", main, oracle, cfg, sql["count"], truths["count"]),
        ("SUM", main, oracle, cfg, sql["sum"], truths["sum"]),
        ("AVG", main, oracle, cfg, sql["avg"], truths["avg"]),
        ("COUNT bf16", main, oracle, dataclasses.replace(cfg, sweep_precision="bf16"),
         sql["count"], truths["count"]),
        ("COUNT int8", main, oracle, dataclasses.replace(cfg, sweep_precision="int8"),
         sql["count"], truths["count"]),
        ("COUNT two-pass", main, oracle, dataclasses.replace(cfg, use_sweep=False),
         sql["count"], truths["count"]),
        ("COUNT hot rows", hcat, lambda nl, names: ArrayOracle(hot.truth), cfg,
         sql["hot"], float(hot.truth.sum(dtype=np.int64))),
    ]
    results = []
    for name, cat, orc, c, q, truth in runs:
        eng = JoinMLEngine(cat, orc, cfg=c, device=device)
        results.append(_timed(name, truth, launches, device,
                              lambda: eng.execute(q, method="auto", seed=SEED)))
    # 3-way chain, streaming through run_auto (prefix sweeps with a per-row
    # scale and the walk sums at the raw exponent)
    t1, t2 = chain.edge_truth
    chain_truth = float(t1.sum(axis=0, dtype=np.int64) @ t2.sum(axis=1, dtype=np.int64))
    results.append(_timed(
        "3-way chain COUNT", chain_truth, launches, device,
        lambda: run_auto(Query(spec=chain.spec(), agg=Agg.COUNT,
                               oracle=chain.oracle(), budget=budget),
                         cfg, seed=SEED, device=device)))
    results.append(_timed(
        "dense COUNT", float(small.truth.sum()), launches, device,
        lambda: run_auto(Query(spec=small.spec(), agg=Agg.COUNT,
                               oracle=small.oracle(), budget=budget // 4),
                         cfg, seed=SEED, device=device)))
    # agreement with the plain versions on the CPU, on a small input
    agree = {}
    for dev in ("cpu", device):
        q = Query(spec=small.spec(), agg=Agg.COUNT, oracle=small.oracle(),
                  budget=budget // 4)
        agree[dev] = run_auto(q, dataclasses.replace(cfg, max_dense_weight_bytes=0),
                              seed=SEED, device=dev)
    a, b = agree["cpu"], agree[device]
    rel = max(abs(b.estimate - a.estimate) / abs(a.estimate),
              abs(b.ci.lo - a.ci.lo) / abs(a.ci.lo), abs(b.ci.hi - a.ci.hi) / abs(a.ci.hi))
    log(json.dumps({"check": "small streaming COUNT, card vs CPU plain versions",
                    "estimate": [a.estimate, b.estimate], "max_rel_diff": rel}))
    if rel > 1e-6:
        fail("the card's estimate disagrees with the CPU's beyond 1e-6")
    for r in results:
        _check_result(r["name"], r["result"], r["truth"])
    paths = {r["name"]: r["path"] for r in results}
    if paths["dense COUNT"] != "dense" or any(
            p != "streaming" for k, p in paths.items() if k != "dense COUNT"):
        fail(f"unexpected dispatch paths {paths}")
    fused = [r for r in results if r["stratify"].get("walk_setup") == "fused"]
    if any(sum(r["pass_counts"].values()) for r in fused):
        fail("the fused path launched a standalone pass")
    if similarity.PASS_COUNTS["edge_row_sums"] == 0 and any(
            r["name"] == "COUNT two-pass" for r in results):
        fail("the two-pass run should recompute its walk sums")
    return results, hot, (ds, main), chain


def _check_result(name, res, truth):
    """The estimate is finite and inside its CI, and within 3 CI half-widths
    of the truth (as phase 4 holds its queries)."""
    if not (np.isfinite(res.estimate) and res.ci.lo <= res.estimate <= res.ci.hi):
        fail(f"{name}: estimate {res.estimate} outside its CI {res.ci}")
    if res.error_ratio(truth) > 3.0:
        fail(f"{name}: |estimate - truth| is {res.error_ratio(truth):.2f} "
             "CI half-widths")


def _check_budget(name, res, budget):
    if res.oracle_calls > budget:
        fail(f"{name}: {res.oracle_calls} Oracle calls over the budget {budget}")


def _timed(name, truth, launches, device, fn):
    from repro_torch.core import similarity
    from repro_torch.kernels import cuda_lib

    before = dict(cuda_lib.LAUNCHES)
    passes0 = dict(similarity.PASS_COUNTS)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
             if v - before.get(k, 0)}
    passes = {k: similarity.PASS_COUNTS[k] - passes0[k] for k in passes0}
    st = res.telemetry.stratify
    stratify = {"path": st.path, **st.extra} if st is not None else {}
    disp = res.telemetry.dispatch
    path = disp.path if disp is not None else res.telemetry.mode
    row = {
        "name": name, "result": res, "truth": truth, "path": path,
        "launches": delta, "pass_counts": passes, "stratify": stratify,
        "wall_s": wall,
    }
    casc = res.telemetry.cascade
    log(json.dumps({
        "query": name, "estimate": res.estimate, "truth": truth,
        "ci": [res.ci.lo, res.ci.hi], "covers": res.ci.contains(truth),
        "error_ratio": res.error_ratio(truth),
        "path": path, "launches": delta, "PASS_COUNTS": passes,
        "topk_retry_rows": _stat(res, "topk_retry_rows"),
        "dense_rescan_rows": _stat(res, "dense_rescan_rows"),
        "oracle_calls": res.oracle_calls, "wall_s": wall,
        "timings_s": res.telemetry.timings,
        **({"cascade": dataclasses.asdict(casc)} if casc is not None else {}),
    }))
    return row


def _stat(res, key):
    st = res.telemetry.stratify
    return None if st is None else st.extra.get(key)


def _busy_ms(events):
    """Length of the union of the device events' spans (kernels, copies,
    and the annotations that mirror host ops on the device timeline and
    overlap them), without CUPTI's own buffer requests."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Activity Buffer Request")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _profiled(fn, require_events=True):
    """Run ``fn`` under torch.profiler; returns its result, the wall ms, the
    device's busy ms (the union of its events' spans) and the device events
    by their summed self time, largest first.  Fails if the profiler saw no
    device event, unless ``require_events`` is false."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # host ops: their kernels count below
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = _busy_ms(prof.events())
    if busy <= 0 and require_events:
        fail("the profiler saw no device event in a run on the card")
    return res, wall, busy, [[k[:60], ms, n] for k, ms, n in rows]


def profile_query(size, catalogs):
    """One more COUNT on the main catalog under torch.profiler: the device's
    busy time against the query's wall time, and the device events by their
    summed self time."""
    from repro_torch.core import JoinMLEngine
    from repro_torch.core.oracle import ArrayOracle

    ds, main = catalogs
    eng = JoinMLEngine(main, lambda nl, names: ArrayOracle(ds.truth), device="cuda")
    sql = ("SELECT COUNT(*) FROM a JOIN b ON NL('same entity') "
           f"ORACLE BUDGET {size.budget} WITH PROBABILITY 0.95")
    res, wall, busy, events = _profiled(lambda: eng.execute(sql, seed=SEED + 1))
    log(json.dumps({"profile": "COUNT on the main catalog", "wall_ms": wall,
                    "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                    "timings_s": res.telemetry.timings, "top_device_events": events[:8]}))


# ---------------------------------------------------------------------------
# phase 4b: the other query methods (the cascade and the paper's baselines)
# ---------------------------------------------------------------------------

def phase4b_query_path(size, device, catalogs, launches):
    """The cascade and the sampling baselines on phase 4's main catalog:
    ``execute(method="bas-cascade")`` (COUNT, SUM, AVG, streaming, the
    similarity proxy; the fused sweep, K1, hands the collection its top-k
    lists, so COUNT runs once more on the two-pass schedule, whose
    collection launches K3 at k 32), ``run_auto`` with ``cfg.cascade``, and
    WWJ (walk mode) and UNIFORM on COUNT.  Launch counts are read around the
    whole run."""
    from repro_torch.core import Agg, JoinMLEngine, Query, run_auto
    from repro_torch.core.oracle import ArrayOracle
    from repro_torch.core.types import BASConfig

    ds, main = catalogs
    budget = size.budget
    row_t = ds.truth.sum(axis=1, dtype=np.int64)
    col_t = ds.truth.sum(axis=0, dtype=np.int64)
    count = float(row_t.sum())
    truths = {"COUNT": count, "SUM": float(ds.columns1["value"] @ row_t),
              "AVG": float(ds.columns2["value"] @ col_t) / count}
    exprs = {"COUNT": "COUNT(*)", "SUM": "SUM(a.value)", "AVG": "AVG(b.value)"}

    def sql(agg):
        return (f"SELECT {exprs[agg]} FROM a JOIN b ON NL('same entity') "
                f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95")

    cfg = BASConfig(max_dense_weight_bytes=size.dense_cap)
    eng = JoinMLEngine(main, lambda nl, names: ArrayOracle(ds.truth), cfg=cfg,
                       device=device)
    results = []
    for agg in ("COUNT", "SUM", "AVG"):
        results.append(_timed(
            f"cascade {agg}", truths[agg], launches, device,
            lambda agg=agg: eng.execute(sql(agg), method="bas-cascade", seed=SEED)))
    two_pass = JoinMLEngine(main, lambda nl, names: ArrayOracle(ds.truth),
                            cfg=dataclasses.replace(cfg, use_sweep=False), device=device)
    results.append(_timed(
        "cascade COUNT two-pass", count, launches, device,
        lambda: two_pass.execute(sql("COUNT"), method="bas-cascade", seed=SEED)))
    results.append(_timed(
        "run_auto cascade COUNT", count, launches, device,
        lambda: run_auto(Query(spec=ds.spec(), agg=Agg.COUNT,
                               oracle=ArrayOracle(ds.truth), budget=budget),
                         dataclasses.replace(cfg, cascade=True), seed=SEED,
                         device=device)))
    for method in ("wwj", "uniform"):
        results.append(_timed(
            f"{method} COUNT", count, launches, device,
            lambda method=method: eng.execute(sql("COUNT"), method=method, seed=SEED)))
    for r in results:
        _check_result(r["name"], r["result"], r["truth"])
        _check_budget(r["name"], r["result"], budget)
    paths = {r["name"]: r["path"] for r in results}
    want = {"cascade COUNT": "bas-cascade", "cascade SUM": "bas-cascade",
            "cascade AVG": "bas-cascade", "cascade COUNT two-pass": "bas-cascade",
            "run_auto cascade COUNT": "cascade-streaming",
            "wwj COUNT": "wwj", "uniform COUNT": "uniform"}
    if paths != want:
        fail(f"unexpected paths {paths}")
    for r in results:
        fused = r["stratify"].get("walk_setup") == "fused"
        if "cascade" in r["name"] and fused == ("two-pass" in r["name"]):
            fail(f"{r['name']}: walk setup {r['stratify'].get('walk_setup')}")
    return results


def phase4b_dense(size, device, launches):
    """ABAE, BlazeIt, blocking and selection at the largest size the dense
    path admits: each materialises the chain weights of the whole cross
    product (a torch matmul on the card, no similarity kernel).  Blocking's
    threshold comes from ``calibrate_threshold`` on a validation split drawn
    from the same generator with another seed."""
    from repro_torch.core import (Agg, BASConfig, Query, calibrate_threshold,
                                  choose_path, dense_weight_bytes, run_abae,
                                  run_bas_selection, run_blazeit, run_blocking)
    from repro_torch.core.similarity import chain_weights
    from repro_torch.data import make_clustered_tables

    n1, n2 = size.dense
    t0 = time.perf_counter()
    kw = dict(d=size.d, n_entities=max(n2 // 16, 16), noise=0.35)
    dd = make_clustered_tables(n1, n2, seed=SEED + 4, **kw)
    val = make_clustered_tables(n1, n2, seed=SEED + 5, **kw)
    log(f"phase 4b dense data: {time.perf_counter() - t0:.1f} s")
    spec = dd.spec()
    log(json.dumps({"dense_baselines": [n1, n2, size.d],
                    "dense_weight_bytes": dense_weight_bytes(spec),
                    "default_path": choose_path(spec, BASConfig())}))
    if size is FULL and not (dense_weight_bytes(spec) == BASConfig().max_dense_weight_bytes
                             and choose_path(spec, BASConfig()) == "dense"):
        fail("the dense baselines' tables are not the largest the dense path admits")
    budget = size.budget
    truth = float(dd.truth.sum(dtype=np.int64))

    def q():
        return Query(spec=spec, agg=Agg.COUNT, oracle=dd.oracle(), budget=budget)

    t0 = time.perf_counter()
    tau = calibrate_threshold(chain_weights(val.spec().embeddings, device=device),
                              val.truth.reshape(-1), 0.9)
    calib_s = time.perf_counter() - t0
    del val
    results = [_timed(name, truth, launches, device, fn) for name, fn in (
        ("abae COUNT", lambda: run_abae(q(), seed=SEED, device=device)),
        ("blazeit COUNT", lambda: run_blazeit(q(), seed=SEED, device=device)),
        ("blocking COUNT", lambda: run_blocking(q(), tau, seed=SEED, device=device)))]
    for r in results[:2]:
        _check_result(r["name"], r["result"], truth)
    blk = results[2]["result"]
    n_cand = blk.telemetry.extra["n_candidates"]
    log(json.dumps({"blocking": {"threshold": tau, "calibrate_s": calib_s,
                                 "n_candidates": n_cand, "estimate": blk.estimate,
                                 "truth": truth, "bias": blk.estimate / truth - 1.0}}))
    if not (np.isfinite(blk.estimate) and n_cand > 0):
        fail(f"blocking: estimate {blk.estimate} over {n_cand} candidates")
    for r in results:
        _check_budget(r["name"], r["result"], budget)
    t0 = time.perf_counter()
    sel = run_bas_selection(q(), recall_target=0.9, seed=SEED, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    flat_truth = dd.truth.reshape(-1)
    hit = int(flat_truth[sel.selected_flat].sum())
    log(json.dumps({"query": "selection, recall target 0.9", "wall_s": time.perf_counter() - t0,
                    "selected": int(len(sel.selected_flat)), "tau_s": sel.tau_s,
                    "recall": hit / truth, "precision": hit / max(len(sel.selected_flat), 1),
                    "oracle_calls": sel.oracle_calls}))
    if sel.oracle_calls > budget:
        fail(f"selection: {sel.oracle_calls} Oracle calls over the budget")
    if not hit > 0:
        fail("selection returned no true match")
    return results


def phase4b_oracle(size, device):
    """The cascade on phase 6's Oracle path: COUNT whose Oracle is the full
    joinml-oracle behind ``PairScorer`` and ``ModelOracle``, with the
    similarity proxy, launch counts set to 0 just before and read just
    after.  The truth is every pair scored by the same scorer."""
    from repro_torch.core import JoinMLEngine, ModelOracle
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cfg, scorer, thr, cat, left, right, sql, _ = oracle_setup(size, device)
    eng = JoinMLEngine(cat, lambda nl, names: ModelOracle(scorer, thr), device=device)
    truth = float((scorer.score(_all_pairs(len(left), len(right))) >= thr).sum())
    log(f"phase 4b oracle set-up: {time.perf_counter() - t0:.1f} s")
    scorer.seconds = 0.0
    cuda_lib.reset_launches()
    row = _timed("Oracle cascade COUNT", truth, cuda_lib.LAUNCHES, device,
                 lambda: eng.execute(sql, method="bas-cascade", seed=SEED))
    launches = dict(cuda_lib.LAUNCHES)
    res = row["result"]
    log(json.dumps({"Oracle cascade": {"model": cfg.name, "layers": cfg.num_layers,
                                       "scoring_s": scorer.seconds,
                                       "oracle_calls": res.oracle_calls,
                                       "proxy_calls": res.telemetry.cascade.proxy_calls}}))
    _check_result("Oracle cascade COUNT", res, truth)
    _check_budget("Oracle cascade COUNT", res, size.budget)
    if device == "cuda" and launches.get("flash_attention", 0) <= 0:
        fail("flash_attention was not launched by the Oracle-path cascade")
    return launches


def phase4b_card_vs_cpu(size, device):
    """Each method on phase 4's small tables on the card and on the CPU:
    UNIFORM exactly; WWJ in flat mode, ABAE, BlazeIt and blocking, each
    handed one weight vector computed once on the card, within 1e-12
    relative; the dense cascade and WWJ's walks, on their own weights,
    within 1e-6 (phase 4's tolerance)."""
    from repro_torch.core import (Agg, Query, calibrate_threshold, run_abae,
                                  run_bas_cascade, run_blazeit, run_blocking,
                                  run_uniform, run_wwj)
    from repro_torch.core.similarity import chain_weights

    small = make_small(size)
    budget = size.budget // 4
    w = chain_weights(small.spec().embeddings, device=device)
    tau = calibrate_threshold(w, small.truth.reshape(-1), 0.9)

    def q(b=budget):
        return Query(spec=small.spec(), agg=Agg.COUNT, oracle=small.oracle(), budget=b)

    runs = {
        "uniform": (0.0, lambda dev: run_uniform(q(), seed=SEED, device=dev)),
        "wwj flat": (1e-12, lambda dev: run_wwj(q(), seed=SEED, weights=w, device=dev)),
        "abae": (1e-12, lambda dev: run_abae(q(), seed=SEED, weights=w, device=dev)),
        "blazeit": (1e-12, lambda dev: run_blazeit(q(), seed=SEED, weights=w, device=dev)),
        "blocking": (1e-12, lambda dev: run_blocking(q(60), tau, seed=SEED, weights=w,
                                                     device=dev)),
        "cascade dense": (1e-6, lambda dev: run_bas_cascade(q(), seed=SEED, path="dense",
                                                            device=dev)),
        "wwj walks": (1e-6, lambda dev: run_wwj(q(), seed=SEED, device=dev)),
    }
    for name, (tol, fn) in runs.items():
        a, b = fn("cpu"), fn(device)
        diffs = [abs(y - x) / max(abs(x), 1e-300) for x, y in
                 ((a.estimate, b.estimate), (a.ci.lo, b.ci.lo), (a.ci.hi, b.ci.hi))]
        rel = max(diffs)
        log(json.dumps({"check": f"{name} COUNT, card vs CPU", "estimate": [a.estimate, b.estimate],
                        "oracle_calls": [a.oracle_calls, b.oracle_calls],
                        "max_rel_diff": rel, "tolerance": tol}))
        if not rel <= tol or a.oracle_calls != b.oracle_calls:
            fail(f"{name}: the card disagrees with the CPU beyond {tol}")


def profile_4b(size, catalogs):
    """One more full-size cascade COUNT and WWJ COUNT under torch.profiler:
    the device's busy time against the query's wall time, and where the
    time goes (WWJ's first run in phase 4b also paid the process's first
    import of ``scipy.stats``)."""
    from repro_torch.core import JoinMLEngine
    from repro_torch.core.oracle import ArrayOracle
    from repro_torch.core.types import BASConfig

    ds, main = catalogs
    eng = JoinMLEngine(main, lambda nl, names: ArrayOracle(ds.truth),
                       cfg=BASConfig(max_dense_weight_bytes=size.dense_cap), device="cuda")
    sql = ("SELECT COUNT(*) FROM a JOIN b ON NL('same entity') "
           f"ORACLE BUDGET {size.budget} WITH PROBABILITY 0.95")
    res, wall, busy, events = _profiled(
        lambda: eng.execute(sql, method="bas-cascade", seed=SEED + 1))
    log(json.dumps({"profile": "cascade COUNT on the main catalog", "wall_ms": wall,
                    "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                    "timings_s": res.telemetry.timings,
                    "cascade": dataclasses.asdict(res.telemetry.cascade),
                    "top_device_events": events[:8]}))
    res, wall, busy, events = _profiled(
        lambda: eng.execute(sql, method="wwj", seed=SEED + 1))
    log(json.dumps({"profile": "WWJ COUNT (walks) on the main catalog", "wall_ms": wall,
                    "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                    "estimate": res.estimate, "top_device_events": events[:8]}))


def run_phase4b(size, model_size, device, catalogs):
    """Phase 4b: the other query methods.  Launch counts are set to 0 just
    before each path (the query path, the dense baselines, the Oracle-path
    cascade) and read just after; the card-vs-CPU checks follow."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.reset_launches()
    results = phase4b_query_path(size, device, catalogs, cuda_lib.LAUNCHES)
    query = dict(cuda_lib.LAUNCHES)
    cuda_lib.reset_launches()
    dense_results = phase4b_dense(size, device, cuda_lib.LAUNCHES)
    dense = dict(cuda_lib.LAUNCHES)
    log(json.dumps({"phase4b_launches": {"query path": query, "dense baselines": dense}}))
    oracle = phase4b_oracle(model_size, device)
    if device == "cuda":
        for name in ("sim_sweep[fp32]", "sim_topk[k=32]"):
            if query.get(name, 0) <= 0:
                fail(f"{name} was not launched by the full-size cascades")
        if any(dense.get(k) for k in SIM_KERNELS):
            fail(f"the dense baselines launched similarity kernels: {dense}")
    phase4b_card_vs_cpu(size, device)
    paths = {"cascade and baselines (4b)": query, "dense baselines (4b)": dense,
             "Oracle cascade (4b)": oracle}
    return results + dense_results, paths


# ---------------------------------------------------------------------------
# phase 4c: the persistent stratification index
# ---------------------------------------------------------------------------

# the artifact of the small-tile case: built on SUB64[0] x SUB64[1] rows (so
# its count tiles hold 32 rows), grown by a left append to SUB64[2] rows,
# then right-appended; the appends' rows, and the launcher's table side
INDEX_FULL = dict(sub64=(32, 4096, 1000), append=1024, launcher_side=4096,
                  launcher_append=256)
INDEX_REHEARSAL = dict(sub64=(32, 256, 200), append=64, launcher_side=128,
                       launcher_append=16)


class _PathLaunches:
    """The index path's own launches: the counts are set to 0 just before
    each of its calls and read just after, so the checks between them (the
    rebuilds, the kernels against their plain versions) count nothing."""

    def __init__(self):
        self.counts = collections.Counter()

    def __call__(self, fn):
        from repro_torch.kernels import cuda_lib

        cuda_lib.reset_launches()
        try:
            return fn()
        finally:
            self.counts.update(cuda_lib.LAUNCHES)


def _same_result(name, a, b):
    """Estimate and CI bit for bit."""
    if (a.estimate, a.ci.lo, a.ci.hi) != (b.estimate, b.ci.lo, b.ci.hi):
        fail(f"{name}: {a.estimate} [{a.ci.lo}, {a.ci.hi}] differs from the fresh "
             f"run's {b.estimate} [{b.ci.lo}, {b.ci.hi}]")


def _artifacts_equal(name, got, want, regroup=None):
    """``got`` (grown by appends) against ``want`` (a rebuild): key, sizes,
    counts, every count tile (regrouped to the rebuild's stride where the
    artifact keeps a finer one) and the valid top-k bit for bit; the walk
    sums and total weight within 1e-6 relative."""
    from repro_torch.core.index import _regroup_tiles

    bc = np.asarray(got.block_counts)
    if got.block_rows != want.block_rows:
        bc = _regroup_tiles(bc, got.block_rows, want.block_rows)
    checks_ = {
        "key": got.key == want.key, "sizes": got.sizes == want.sizes,
        "counts": np.array_equal(np.asarray(got.counts), np.asarray(want.counts)),
        "tiles": np.array_equal(bc, np.asarray(want.block_counts)),
    }
    if want.topk_vals is not None:
        ok = np.asarray(want.topk_valid)
        checks_["topk"] = (np.array_equal(np.asarray(got.topk_valid), ok)
                           and np.array_equal(np.asarray(got.topk_vals)[ok],
                                              np.asarray(want.topk_vals)[ok])
                           and np.array_equal(np.asarray(got.topk_idx)[ok],
                                              np.asarray(want.topk_idx)[ok]))
    rel = None
    if want.row_sums is not None:
        g, w = np.asarray(got.row_sums[0]), np.asarray(want.row_sums[0])
        rel = max(float(np.max(np.abs(g - w) / np.abs(w))),
                  abs(got.total_weight - want.total_weight) / abs(want.total_weight))
        checks_["sums"] = rel <= 1e-6
    log(json.dumps({"check": f"{name}: appends against a rebuild",
                    "equal": checks_, "row_sums_max_rel": rel}))
    if not all(checks_.values()):
        fail(f"{name}: the appended artifact differs from the rebuild: {checks_}")


# the index calls' device time by kind, from the profiler's event names
DEVICE_KINDS = (("sweep kernels", ("sim_kernel", "split_merge")),
                ("uploads", ("Memcpy HtoD",)), ("downloads", ("Memcpy DtoH",)))


def _device_split(fn, device):
    """``fn()`` and its wall ms; on the card, run once under torch.profiler,
    also its device busy ms and its device ms by kind (the sweep kernels,
    uploads, downloads, other).  After a session with many events the
    profiler can lose some or all of a later session's device events, so
    the split is kept only if it saw every sweep launch the call counted
    and an upload; else it is reported as not measured."""
    from repro_torch.kernels import cuda_lib

    if device != "cuda":
        t0 = time.perf_counter()
        res = fn()
        return res, {"wall_ms": (time.perf_counter() - t0) * 1e3}
    before = dict(cuda_lib.LAUNCHES)
    res, wall, busy, events = _profiled(fn, require_events=False)
    launched = sum(v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
                   if k.startswith("sim_sweep"))
    by_kind = {kind: 0.0 for kind, _ in DEVICE_KINDS} | {"other": 0.0}
    seen = 0
    for key, ms, count in events:
        kind = next((k for k, keys in DEVICE_KINDS if any(x in key for x in keys)), "other")
        by_kind[kind] += ms
        seen += count if "sim_kernel" in key else 0
    if seen < launched or by_kind["uploads"] <= 0:
        return res, {"wall_ms": wall, "device_ms": "not measured: the profiler lost "
                     f"events ({seen} of {launched} sweep launches seen)"}
    return res, {"wall_ms": wall, "device_busy_ms": busy, "device_ms_by_kind": by_kind}


def _append_vs_rebuild(name, art, steps, device, path, **build_kw):
    """Apply ``steps`` ((table, rows), ...) to ``art`` with ``append_rows``
    (counted by ``path``) and rebuild over the grown tables with
    ``build_index`` (a check, not counted); prints each append's and the
    rebuild's wall ms and device split (``_device_split``) and holds the
    two equal.  Returns the grown artifact."""
    from repro_torch.core import append_rows, build_index

    timings = []
    for table, rows in steps:
        art, timing = path(lambda a=art, t=table, r=rows: _device_split(
            lambda: append_rows(a, t, r, device=device), device))
        timings.append({"append": f"{len(rows)} rows to table {table}",
                        "delta_tiles": art.stats["last_delta_blocks"], **timing})
    ref, timing = _device_split(
        lambda: build_index(art.embeddings, n_bins=art.n_bins, exponent=art.exponent,
                            floor=art.floor, precision=art.precision_requested,
                            tolerance=float("inf"), device=device), device)
    log(json.dumps({"index appends": name, "precision": art.precision,
                    "sizes": art.sizes, "block_rows": art.block_rows,
                    "appends": timings, "rebuild": timing}))
    if art.precision != build_kw.get("precision", "fp32"):
        fail(f"{name}: the index is {art.precision}")
    _artifacts_equal(name, art, ref)
    return art


def _small_tile_case(sizes, d, device, path):
    """An artifact built while its left table had 32 rows keeps 32-row count
    tiles; a left append grows the table and a right append then sweeps all
    of its rows at that stride (tiles of fewer rows than a CTA's, one launch
    a tile on the card).  Held against a rebuild and, on the card, against
    the same appends on the CPU under the edge and near-tie rules."""
    from repro_torch.core import append_rows, build_index
    from repro_torch.core.similarity import normalize
    from repro_torch.kernels import checks

    n1, n2, grown_n1 = sizes
    rng = np.random.default_rng(SEED + 9)
    e1 = normalize(rng.standard_normal((grown_n1, d))).astype(np.float32)
    e2 = normalize(rng.standard_normal((n2 + n2 // 4, d))).astype(np.float32)
    steps = [(0, e1[n1:]), (1, e2[n2:])]

    def base(dev):
        art = build_index([e1[:n1], e2[:n2]], device=dev)
        if art.block_rows != 32:
            fail(f"small-tile case: block_rows {art.block_rows}")
        return art

    card = _append_vs_rebuild("fp32, 32-row tiles", path(lambda: base(device)), steps,
                              device, path)
    if device != "cuda":
        return
    plain = base("cpu")
    for table, rows in steps:
        plain = append_rows(plain, table, rows, device="cpu")
    s64, bound = checks.exact_scores(torch.from_numpy(e1).cuda(),
                                     torch.from_numpy(e2).cuda())
    c = checks.check_counts([torch.from_numpy(card.block_counts),
                             torch.from_numpy(plain.block_counts)],
                            s64, bound, n_bins=card.n_bins, exponent=card.exponent,
                            floor=card.floor, bm=32)
    t = checks.check_topk(*(torch.from_numpy(np.asarray(x)) for x in (
        card.topk_vals, card.topk_idx, plain.topk_vals, plain.topk_idx)), s64, bound)
    rel = checks.check_sums(torch.from_numpy(card.row_sums[0]), s64,
                            exponent=card.exponent, floor=card.floor)
    log(json.dumps({"check": "fp32, 32-row tiles: the card's appends against the plain "
                             "version's (edge rule, near-tie rule, sums 1e-6)",
                    "counts": c, "topk": t, "sums_max_rel": rel}))


def _delta_sweep_checks(ds, extra, block_rows):
    """The sweep kernel against its plain version at the shapes the appends
    give it, at the artifact's tile stride: a right append's delta (every
    left row against the new columns) at each precision, and one chunk of
    the fp32 left append (``block_rows`` new rows against the grown right
    table).  Returns the largest top-k value difference by kernel."""
    errs = {}
    for precision, name in SWEEP_NAMES.items():
        *_, errs[name] = check_sweep(f"{name}, right-append delta", ds.emb1, extra.emb2,
                                     precision, bm=block_rows)
        torch.cuda.empty_cache()
    grown = np.concatenate([ds.emb2, extra.emb2])
    *_, err = check_sweep("sim_sweep[fp32], left-append chunk", extra.emb1[:block_rows],
                          grown, "fp32", bm=block_rows)
    errs["sim_sweep[fp32]"] = max(errs["sim_sweep[fp32]"], err)
    torch.cuda.empty_cache()
    return errs


def _run_launcher(root, knobs, device):
    """The launcher's two index modes as subprocesses; the refreshed
    artifact must load and verify."""
    import shutil as _shutil

    from repro_torch.checkpoint.index_io import list_indexes, load_index
    from repro_torch.core import artifact_key

    _shutil.rmtree(root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--index-root", root,
            "--device", device]
    for argv in (["--mode", "build-index", "--n-side", str(knobs["launcher_side"])],
                 ["--mode", "refresh-index", "--append-rows", str(knobs["launcher_append"])]):
        t0 = time.perf_counter()
        out = subprocess.run(base + argv, capture_output=True, text=True, cwd=HERE,
                             env=env, timeout=600)
        log(json.dumps({"launcher": argv[1], "rc": out.returncode,
                        "wall_s": time.perf_counter() - t0,
                        "stdout": out.stdout.strip()[-400:]}))
        if out.returncode != 0:
            fail(f"launcher --mode {argv[1]} exited {out.returncode}:\n{out.stderr[-3000:]}")
    newest = max(list_indexes(root), key=lambda x: x["version"])
    art = load_index(root, newest["key"])
    side = knobs["launcher_side"]
    if (art.version != 2 or art.sizes != (side, side + knobs["launcher_append"])
            or art.key != artifact_key(art.embeddings, art.n_bins, art.exponent,
                                       art.floor, art.precision_requested)):
        fail(f"the refreshed artifact does not verify: {newest}")


def run_phase4c(size, device, catalogs, hot, chain, results, results_4b, knobs):
    """Phase 4c: the persistent stratification index on phase 4's tables.
    Builds the fp32 index through an ``IndexStore`` and saves it; loads it
    into a new store (mmap); COUNT, SUM, AVG, the hot-row COUNT, a cascade
    COUNT and the 3-way chain through ``JoinMLEngine(index_store=...)`` /
    ``run_auto`` against phases 4 and 4b bit for bit, the warm queries
    launching no sweep; appends against rebuilds (fp32 right then left, int8
    and bf16 right, and the 32-row-tile case); on the card, the sweep
    kernel against its plain version at the appends' shapes; the launcher's
    two modes.  Returns the warm queries' rows, the path's launch counts
    (its builds, queries and appends, not its checks) and the kernels'
    largest top-k value differences at the appends' shapes."""
    import shutil as _shutil

    from repro_torch.checkpoint.index_io import load_index, save_index
    from repro_torch.core import (Agg, Catalog, IndexStore, JoinMLEngine, Query,
                                  Table, artifact_key, build_index, run_auto)
    from repro_torch.core.oracle import ArrayOracle
    from repro_torch.core.types import BASConfig
    from repro_torch.data import make_clustered_tables
    from repro_torch.kernels import cuda_lib

    ds, main = catalogs
    budget = size.budget
    cfg = BASConfig(max_dense_weight_bytes=size.dense_cap)
    params = dict(n_bins=4096, exponent=cfg.weight_exponent, floor=cfg.weight_floor,
                  precision=cfg.sweep_precision)
    fresh = {r["name"]: r for r in results + results_4b}
    root = os.path.join(HERE, "build", "index_smoke")
    _shutil.rmtree(root, ignore_errors=True)
    path = _PathLaunches()

    # 1. the fp32 index, built through a store and saved
    store = IndexStore(root=root, device=device)
    t0 = time.perf_counter()
    art, hit = path(lambda: store.get_or_build([ds.emb1, ds.emb2], **params))
    build_s = time.perf_counter() - t0
    built = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    save_index(root, art)
    save_s = time.perf_counter() - t0
    log(json.dumps({"index": "built", "sizes": art.sizes, "block_rows": art.block_rows,
                    "build_s": build_s, "save_s": save_s,
                    "artifact_mb": art.nbytes / 2**20, "launches": built}))
    if hit or (device == "cuda" and built != {"sim_sweep[fp32]": 1}):
        fail(f"the index build launched {built} (hit {hit})")

    # 2. a new store loads it from disk (mmap); the store first derives the
    # content key from the live tables, so its load includes their hash
    t0 = time.perf_counter()
    load_index(root, art.key)
    load_index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    artifact_key([ds.emb1, ds.emb2], **params)
    key_s = time.perf_counter() - t0
    warm = IndexStore(root=root, device=device)
    t0 = time.perf_counter()
    loaded, hit = path(lambda: warm.get_or_build([ds.emb1, ds.emb2], **params))
    load_s = time.perf_counter() - t0
    log(json.dumps({"index": "loaded", "store_load_s": load_s,
                    "load_index_s": load_index_s, "artifact_key_s": key_s,
                    "stats": warm.stats()}))
    if hit or warm.stats()["index_load"] != 1 or warm.stats()["index_build"] != 0:
        fail(f"the index did not load from disk: {warm.stats()}")

    # 3. COUNT, SUM, AVG through the engine: streaming-index, no sweep, no
    # standalone pass, each equal to phase 4's fresh run
    sql = {
        "COUNT": "SELECT COUNT(*) FROM a JOIN b ON NL('same entity') "
                 f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
        "SUM": "SELECT SUM(a.value) FROM a JOIN b ON NL('same entity') "
               f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
        "AVG": "SELECT AVG(b.value) FROM a JOIN b ON NL('same entity') "
               f"ORACLE BUDGET {budget} WITH PROBABILITY 0.95",
    }
    eng = JoinMLEngine(main, lambda nl, names: ArrayOracle(ds.truth), cfg=cfg,
                       index_store=warm, device=device)
    rows = []
    for name, q in sql.items():
        row = path(lambda q=q, n=name: _timed(
            f"{n} warm index", fresh[n]["truth"], cuda_lib.LAUNCHES, device,
            lambda: eng.execute(q, method="auto", seed=SEED)))
        rows.append(row)
        log(json.dumps({"warm against fresh": name,
                        "wall_s": [row["wall_s"], fresh[name]["wall_s"]],
                        "stratify_s": [row["result"].telemetry.timings["stratify_s"],
                                       fresh[name]["result"].telemetry.timings["stratify_s"]]}))
        _same_result(row["name"], row["result"], fresh[name]["result"])
    # the cascade COUNT, stage 1 from the store
    row = path(lambda: _timed(
        "cascade COUNT warm index", fresh["cascade COUNT"]["truth"], cuda_lib.LAUNCHES,
        device, lambda: eng.execute(sql["COUNT"], method="bas-cascade", seed=SEED)))
    rows.append(row)
    _same_result(row["name"], row["result"], fresh["cascade COUNT"]["result"])
    if row["result"].telemetry.index is None or not row["result"].telemetry.index.hit:
        fail("the cascade did not stratify from the index")

    # 4. the hot-row COUNT from its own index: the k = 128 retry runs over
    # the live embeddings
    hcat = Catalog()
    hcat.register(Table("h", hot.emb1, hot.columns1))
    hcat.register(Table("b", hot.emb2, hot.columns2))
    path(lambda: warm.get_or_build([hot.emb1, hot.emb2], **params))
    heng = JoinMLEngine(hcat, lambda nl, names: ArrayOracle(hot.truth), cfg=cfg,
                        index_store=warm, device=device)
    row = path(lambda: _timed(
        "COUNT hot rows warm index", fresh["COUNT hot rows"]["truth"], cuda_lib.LAUNCHES,
        device, lambda: heng.execute(sql["COUNT"].replace("FROM a", "FROM h"),
                                     method="auto", seed=SEED)))
    rows.append(row)
    _same_result(row["name"], row["result"], fresh["COUNT hot rows"]["result"])
    if device == "cuda" and row["launches"].get("sim_topk[k=128]", 0) <= 0:
        fail("the hot-row warm query did not launch sim_topk[k=128]")

    # 5. the 3-way chain, hydrated
    chain_embs = [np.asarray(e, np.float32) for e in chain.spec().embeddings]
    path(lambda: warm.get_or_build(chain_embs, **params))
    row = path(lambda: _timed(
        "3-way chain COUNT warm index", fresh["3-way chain COUNT"]["truth"],
        cuda_lib.LAUNCHES, device,
        lambda: run_auto(Query(spec=chain.spec(), agg=Agg.COUNT, oracle=chain.oracle(),
                               budget=budget),
                         cfg, seed=SEED, index_store=warm, device=device)))
    rows.append(row)
    _same_result(row["name"], row["result"], fresh["3-way chain COUNT"]["result"])

    for r in rows:
        if r["name"] != "cascade COUNT warm index" and r["path"] != "streaming-index":
            fail(f"{r['name']}: dispatch path {r['path']}")
        if any(r["launches"].get(k, 0) for k in cuda_lib.LAUNCHES if k.startswith("sim_sweep")):
            fail(f"{r['name']}: a warm query launched a sweep: {r['launches']}")
        if sum(r["pass_counts"].values()):
            fail(f"{r['name']}: a warm query launched a standalone pass")
    if device == "cuda":
        res, wall, busy, events = path(lambda: _profiled(
            lambda: eng.execute(sql["COUNT"], seed=SEED + 1)))
        log(json.dumps({"profile": "warm-index COUNT on the main catalog", "wall_ms": wall,
                        "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                        "timings_s": res.telemetry.timings,
                        "top_device_events": events[:8]}))

    # 6. appends against rebuilds on the card: fp32 right then left, int8
    # and bf16 right, the 32-row-tile case
    extra = make_clustered_tables(knobs["append"], knobs["append"], d=size.d,
                                  n_entities=512, noise=0.35, seed=SEED + 7)
    _append_vs_rebuild("fp32", loaded, [(1, extra.emb2), (0, extra.emb1)], device, path)
    for prec in ("int8", "bf16"):
        lowp = path(lambda p=prec: build_index([ds.emb1, ds.emb2],
                                               **{**params, "precision": p},
                                               tolerance=float("inf"), device=device))
        _append_vs_rebuild(prec, lowp, [(1, extra.emb2)], device, path, precision=prec)
        del lowp
    _small_tile_case(knobs["sub64"], size.d, device, path)
    errs = {}
    if device == "cuda":
        errs = _delta_sweep_checks(ds, extra, loaded.block_rows)

    # 7. the launcher's two index modes
    _run_launcher(os.path.join(HERE, "build", "index_launcher"), knobs, device)
    _shutil.rmtree(root, ignore_errors=True)
    _shutil.rmtree(os.path.join(HERE, "build", "index_launcher"), ignore_errors=True)
    return rows, dict(path.counts), errs


# ---------------------------------------------------------------------------
# phases 3 and 5: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def _log_tuning(where):
    """The autotuner's entries and the seconds it spent measuring them, apart
    from the timed queries (a query that met a new shape bucket first
    includes its measurement)."""
    from repro_torch.kernels import autotune

    secs = autotune.tuning_seconds()
    log(json.dumps({"autotune": where, "entries": {k: list(v) for k, v in
                                                   autotune.cache_info().items()},
                    "tuning_s": secs, "tuning_s_total": sum(secs.values())}))


def _events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms_by_kernel(fn, reps):
    """Device time a call of ``fn`` spends in each kernel it launches
    (torch.profiler), in ms, by the kernel's full name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            out[e.key] += e.self_device_time_total / 1e3 / reps
    return dict(out)


def kernel_inputs(e1, e2, precision):
    from repro_torch.core.similarity import quantize_rows_int8

    dev = torch.device("cuda")
    if precision == "int8":
        q1, r1 = quantize_rows_int8(e1)
        q2, r2 = quantize_rows_int8(e2)
        return [torch.from_numpy(x).to(dev) for x in
                (q1, q2, r1.reshape(-1), r2.reshape(-1))]
    return [torch.from_numpy(e1).to(dev), torch.from_numpy(e2).to(dev), None, None]


def sweep_fns(e1, e2, precision, k=32, bm=256):
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand, sim_sweep_cuda
    from repro_torch.kernels.sim_sweep.ref import sim_sweep_ref

    a, b, rs1, rs2 = kernel_inputs(e1, e2, precision)
    m, n = a.shape[0], b.shape[0]
    scale = torch.ones(m, device="cuda")
    v = torch.ones(n, device="cuda")
    ka, kb = kernel_operand(a, precision), kernel_operand(b, precision)
    kw = dict(n_bins=4096, exponent=1.0, floor=1e-3, k=k, bm=bm,
              precision=precision, rs1=rs1, rs2=rs2)
    kern = lambda: sim_sweep_cuda(ka, kb, scale, v, **kw)  # noqa: E731
    plain = lambda: sim_sweep_ref(a, b, scale, v, **kw)  # noqa: E731
    return kern, plain, (a, b, rs1, rs2, scale, v)


SWEEP_NAMES = {"fp32": "sim_sweep[fp32]", "bf16": "sim_sweep[bf16]",
               "int8": "sim_sweep_q[int8]"}


def check_sweep(name, e1, e2, precision, k=32, bm=256):
    """The sweep kernel against its plain version on the card, on the same
    ``e1`` x ``e2`` at ``k`` and ``bm``: count tiles under the edge rule,
    top-k under the near-tie rule, walk sums within 1e-6 of the exact f64
    sums, and the int8 sweep bit for bit; fails on a violation.  Returns
    the operands, the kernel's tiles and top-k, the exact scores with their
    bound, and the largest top-k value difference."""
    from repro_torch.kernels import checks

    kern, plain, (a, b, rs1, rs2, scale, v) = sweep_fns(e1, e2, precision, k, bm)
    kb, kv, ki, ks = kern()
    torch.cuda.synchronize()
    pb, pv, pi, ps = plain()
    s64, bound = checks.exact_scores(a, b, precision, rs1, rs2)
    try:
        c = checks.check_counts([kb, pb], s64, bound, n_bins=4096, exponent=1.0,
                                floor=1e-3, bm=bm, scale=scale)
        t = checks.check_topk(kv, ki, pv, pi, s64, bound)
        rel = checks.check_sums(ks, s64, exponent=1.0, floor=1e-3, v=v)
        rel_plain = checks.check_sums(ps, s64, exponent=1.0, floor=1e-3, v=v)
    except AssertionError as exc:
        fail(f"{name} at {a.shape[0]} x {b.shape[0]}, bm {bm}: {exc}")
    err = float((kv.double() - pv.double()).abs().max())
    log(json.dumps({"check": name, "rows": a.shape[0], "cols": b.shape[0], "bm": bm,
                    "k": k, "uncertain_elements": c["uncertain"],
                    "count_mismatch": c["mismatch"], "topk_mismatch": t["mismatch"],
                    "sum_rel_err": rel, "plain_sum_rel_err": rel_plain,
                    "max_abs_err_vals": err}))
    if precision == "int8" and not (torch.equal(kb, pb) and torch.equal(kv, pv)
                                    and torch.equal(ki, pi)):
        fail(f"{name} at {a.shape[0]} x {b.shape[0]} is not bit-identical to its "
             "plain version")
    return a, b, kb, kv, ki, s64, bound, err


def phase3(ds, rows):
    from repro_torch.kernels import checks, cuda_lib
    from repro_torch.kernels.sim_hist.kernel import sim_hist_cuda
    from repro_torch.kernels.sim_hist.ref import sim_hist_ref
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand
    from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda
    from repro_torch.kernels.sim_topk.ref import sim_topk_ref

    errs = {}
    for precision, name in SWEEP_NAMES.items():
        a, b, kb, kv, ki, s64, bound, errs[name] = check_sweep(
            name, ds.emb1[:rows], ds.emb2, precision)
        if precision == "fp32":
            fp32 = (a, b, kb, kv, ki, s64, bound)
        if precision == "bf16":
            bf16_two_pass(a, b, kb, kv, ki, s64, bound)
        del s64, bound
        torch.cuda.empty_cache()
    a, b, kb, kv, ki, s64, bound = fp32
    a4, b4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    ones = torch.ones(a.shape[0], device="cuda")
    hist = sim_hist_cuda(a4, b4, ones, n_bins=4096)
    tv, ti = sim_topk_cuda(a4, b4, k=32)
    torch.cuda.synchronize()
    identical = bool(torch.equal(kb.sum(dim=0), hist) and torch.equal(kv, tv)
                     and torch.equal(ki, ti))
    log(json.dumps({"check": "fp32 sweep == sim_hist + sim_topk[k=32]",
                    "bit_identical": identical}))
    if not identical:
        fail("fp32 sweep differs from the two-pass kernels")
    ph = sim_hist_ref(a, b, ones, n_bins=4096)
    c = checks.check_counts([hist[None], ph[None]], s64, bound, n_bins=4096,
                            exponent=1.0, floor=1e-3, bm=a.shape[0])
    errs["sim_hist"] = float((hist - ph).abs().max())
    log(json.dumps({"check": "sim_hist", "uncertain_elements": c["uncertain"],
                    "count_mismatch": c["mismatch"]}))
    for k in (32, 128):
        kv2, ki2 = sim_topk_cuda(a4, b4, k=k)
        torch.cuda.synchronize()
        pv2, pi2 = sim_topk_ref(a, b, k=k)
        t = checks.check_topk(kv2, ki2, pv2, pi2, s64, bound)
        errs[f"sim_topk[k={k}]"] = float((kv2.double() - pv2.double()).abs().max())
        log(json.dumps({"check": f"sim_topk[k={k}]", "topk_mismatch": t["mismatch"],
                        "max_abs_err_vals": errs[f"sim_topk[k={k}]"]}))
    # the raised-k retry's shape: HOT_ROWS rows take the few-row kernels;
    # the top 32 of their k-128 lists equal the fp32 sweep's k-32 lists
    r = HOT_ROWS
    fv, fi = sim_topk_cuda(kernel_operand(a[:r], "fp32"), b4, k=128)
    torch.cuda.synchronize()
    same = bool(torch.equal(fv[:, :32], kv[:r]) and torch.equal(fi[:, :32], ki[:r]))
    pv3, pi3 = sim_topk_ref(a[:r], b, k=128)
    t = checks.check_topk(fv, fi, pv3, pi3, s64[:r], bound[:r])
    err = float((fv.double() - pv3.double()).abs().max())
    errs["sim_topk[k=128]"] = max(errs["sim_topk[k=128]"], err)
    log(json.dumps({"check": f"sim_topk[k=128], {r} rows (the few-row kernels)",
                    "few_row_kernels": cuda_lib.few_rows("fp32", cuda_lib.TOPK, r),
                    "top32_equal_fp32_sweep": same, "topk_mismatch": t["mismatch"],
                    "max_abs_err_vals": err}))
    if not same:
        fail("the few-row top-k's first 32 entries differ from the fp32 sweep's lists")
    del s64, bound
    torch.cuda.empty_cache()
    return errs


def bf16_two_pass(a, b, kb, kv, ki, s64, bound):
    """The bf16 sweep against the bf16 histogram and top-k launches (bit for
    bit: every score takes the same mmas and flushes), and the largest error
    of the scores it kept, |score - exact| / bound, under the rule's bound
    gamma_d sum |a_i b_i| (the tensor cores' rounding inside an mma is not
    documented; each 64-column slice is flushed into the f32 sum with
    round-to-nearest)."""
    from repro_torch.kernels.sim_hist.kernel import sim_hist_cuda
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand
    from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda

    a2, b2 = kernel_operand(a, "bf16"), kernel_operand(b, "bf16")
    ones = torch.ones(a.shape[0], device="cuda")
    hist = sim_hist_cuda(a2, b2, ones, n_bins=4096, precision="bf16")
    tv, ti = sim_topk_cuda(a2, b2, k=kv.shape[1], precision="bf16")
    torch.cuda.synchronize()
    identical = bool(torch.equal(kb.sum(dim=0), hist) and torch.equal(kv, tv)
                     and torch.equal(ki, ti))
    kept = torch.gather(s64, 1, ki.long()).clamp(0.0, 1.0)
    ratio = float(((kv.double() - kept).abs() / torch.gather(bound, 1, ki.long())).max())
    log(json.dumps({"check": "bf16 sweep == sim_hist + sim_topk[k=32] at bf16",
                    "bit_identical": identical,
                    "max_score_err_over_bound": ratio}))
    if not identical:
        fail("bf16 sweep differs from the bf16 two-pass launches")
    if not ratio <= 1.0:
        fail(f"a bf16 score is off by {ratio} times its bound")


def chain_check(chain):
    """The 3-way chain's first prefix block as ``sweep_pass_chain`` sweeps it
    on the main path: the prefix rows ``e_prev[i_last]`` against the last
    table, binned at ``exponent * root`` = 0.5 (the powf branch) with the
    per-row scale ``wp**0.5``, walk sums at the raw exponent 1, top-1.  Its
    32 CTAs of 128 rows split their columns; the split launch must equal an
    unsplit one in counts and top-k, and both sums lie within 1e-6 of f64."""
    from repro_torch.core.stratify import _prefix_chain_weights
    from repro_torch.kernels import checks, cuda_lib
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand, sim_sweep_cuda
    from repro_torch.kernels.sim_sweep.ref import sim_sweep_ref

    embs = chain.embeddings
    root = 1.0 / (len(embs) - 1)
    rows = min(4096, embs[0].shape[0] * embs[1].shape[0])  # the sweep's block
    wp, i_last = _prefix_chain_weights(embs, 0, rows, 1.0, 1e-3)
    a = torch.from_numpy(np.ascontiguousarray(embs[-2][i_last])).cuda()
    b = torch.from_numpy(embs[-1]).cuda()
    scale = torch.from_numpy((wp**root).astype(np.float32)).cuda()
    v = torch.ones(b.shape[0], device="cuda")
    kw = dict(n_bins=4096, exponent=root, rs_exponent=1.0, floor=1e-3, k=1, bm=256)
    ka, kb4 = kernel_operand(a, "fp32"), kernel_operand(b, "fp32")
    kb, kv, ki, ks = sim_sweep_cuda(ka, kb4, scale, v, **kw)
    ub, uv, ui, us = sim_sweep_cuda(ka, kb4, scale, v, splits=1, **kw)
    torch.cuda.synchronize()
    rows_t = cuda_lib.tile_rows(a.shape[0], kw["bm"])
    splits = cuda_lib.column_splits(a.shape[0], b.shape[0],
                                    torch.cuda.get_device_properties(0).multi_processor_count,
                                    rows_t)
    same = bool(torch.equal(kb, ub) and torch.equal(kv, uv) and torch.equal(ki, ui))
    pb, pv, pi, ps = sim_sweep_ref(a, b, scale, v, **kw)
    s64, bound = checks.exact_scores(a, b)
    rel_unsplit = checks.check_sums(us, s64, exponent=1.0, floor=1e-3, v=v)
    log(json.dumps({"check": "split sweep == unsplit sweep, 3-way chain prefix block",
                    "tile_rows": rows_t, "column_ranges": splits,
                    "counts_and_topk_identical": same, "unsplit_sum_rel_err": rel_unsplit,
                    "max_abs_sum_diff": float((ks.double() - us.double()).abs().max())}))
    if not same or splits < 2:
        fail("the split chain-prefix sweep differs from the unsplit one (or did not split)")
    c = checks.check_counts([kb, pb], s64, bound, n_bins=4096, exponent=root,
                            floor=1e-3, bm=256, scale=scale)
    t = checks.check_topk(kv, ki, pv, pi, s64, bound)
    rel = checks.check_sums(ks, s64, exponent=1.0, floor=1e-3, v=v)
    rel_plain = checks.check_sums(ps, s64, exponent=1.0, floor=1e-3, v=v)
    err = float((kv.double() - pv.double()).abs().max())
    log(json.dumps({"check": "sim_sweep[fp32], 3-way chain prefix block",
                    "rows": rows, "cols": b.shape[0], "exponent": root,
                    "rs_exponent": 1.0, "uncertain_elements": c["uncertain"],
                    "count_mismatch": c["mismatch"], "topk_mismatch": t["mismatch"],
                    "sum_rel_err": rel, "plain_sum_rel_err": rel_plain,
                    "max_abs_err_vals": err}))
    del s64, bound
    # the prefix launch's time, split as the main path runs it and unsplit
    timing = {"chain_prefix_ms": _events_ms(lambda: sim_sweep_cuda(ka, kb4, scale, v, **kw), 20),
              "chain_prefix_unsplit_ms": _events_ms(
                  lambda: sim_sweep_cuda(ka, kb4, scale, v, splits=1, **kw), 20),
              "chain_prefix_column_ranges": splits}
    log(json.dumps({"time": "sim_sweep[fp32], 3-way chain prefix block", **timing}))
    torch.cuda.empty_cache()
    return err, timing


def phase5(ds, retry_rows, hot):
    """Times at the phase-4 shapes: every sweep and the two-pass kernels on
    the full product; the k=128 retry on the hot catalog's retried rows."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.sim_hist.kernel import sim_hist_cuda
    from repro_torch.kernels.sim_hist.ref import sim_hist_ref
    from repro_torch.kernels.sim_sweep.kernel import kernel_operand
    from repro_torch.kernels.sim_topk.kernel import sim_topk_cuda
    from repro_torch.kernels.sim_topk.ref import sim_topk_ref
    from repro_torch.roofline import kernel_work

    n = ds.emb1.shape[0]
    d = ds.emb1.shape[1]
    times = {}
    for precision, name in SWEEP_NAMES.items():
        kern, plain, (a, b, *_rest) = sweep_fns(ds.emb1[:n], ds.emb2, precision)
        m = a.shape[0]
        ms = _events_ms(kern, 3)
        pms = _events_ms(plain, 1)
        times[name] = _row(ms, pms, *kernel_work.work("sim_sweep", m=m, n=n, d=d,
                                                      precision=precision))
        if precision == "int8":  # context only: no one call computes K2's outputs
            int_mm_ms = _events_ms(lambda: torch._int_mm(a, b.T), 3)
        del kern, plain, a, b
        torch.cuda.empty_cache()
    e1 = torch.from_numpy(ds.emb1).cuda()
    e2 = torch.from_numpy(ds.emb2).cuda()
    a4, b4 = kernel_operand(e1, "fp32"), kernel_operand(e2, "fp32")
    ones = torch.ones(n, device="cuda")
    times["sim_hist"] = _row(_events_ms(lambda: sim_hist_cuda(a4, b4, ones, n_bins=4096), 3),
                             _events_ms(lambda: sim_hist_ref(e1, e2, ones, n_bins=4096), 1),
                             *kernel_work.work("sim_hist", m=n, n=n, d=d, n_bins=4096))
    times["sim_topk[k=32]"] = _row(_events_ms(lambda: sim_topk_cuda(a4, b4, k=32), 3),
                                   _events_ms(lambda: sim_topk_ref(e1, e2, k=32), 1),
                                   *kernel_work.work("sim_topk", m=n, n=n, d=d, k=32))
    # the retry's shape: the rows the hot query retried, against the full E2
    r = max(int(retry_rows or 0), 1)
    h1p, hb = retry_operands(hot, r)
    h14, hb4 = kernel_operand(h1p, "fp32"), kernel_operand(hb, "fp32")
    # a call is short enough that the host's work between calls shows in
    # its time (CUDA events, as for every kernel); beside it, the device
    # time of the kernels a call launches
    retry = lambda: sim_topk_cuda(h14, hb4, k=128)  # noqa: E731
    times["sim_topk[k=128]"] = _row(
        _events_ms(retry, 20), _events_ms(lambda: sim_topk_ref(h1p, hb, k=128), 3),
        *kernel_work.work("sim_topk", m=h1p.shape[0], n=n, d=d, k=128))
    by_kernel = device_ms_by_kernel(retry, 20)
    times["sim_topk[k=128]"].update(device_ms=sum(by_kernel.values()),
                                    device_ms_by_kernel=by_kernel)
    times["sim_topk[k=128]"]["rows"] = int(h1p.shape[0])
    times["sim_topk[k=128]"]["kernel"] = (
        "few-row" if cuda_lib.few_rows("fp32", cuda_lib.TOPK, h1p.shape[0]) else "tile")
    matmul_ms = _events_ms(lambda: torch.matmul(e1, e2.T), 3)
    log(json.dumps({"context": "torch.matmul of the bare fp32 score product",
                    "shape": [n, n, d], "matmul_ms": matmul_ms}))
    log(json.dumps({"context": "torch._int_mm of the bare int8 score product",
                    "shape": [n, n, d], "int_mm_ms": int_mm_ms}))
    return times


def ptxas_report(text, kernel):
    """ptxas -v's registers and spill bytes of each instantiation of
    ``kernel`` in a build log: [{entry, registers, spill_stores,
    spill_loads}]."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            cur = None
            if kernel in name:
                cur = next((e for e in out if e["entry"] == name), None)
                if cur is None:
                    cur = {"entry": name}
                    out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _row(ms, plain_ms, flops, byts, peak):
    """A kernel's row: its time and its plain version's beside the bound of
    its work (``roofline.kernel_work``)."""
    from repro_torch.roofline import kernel_work

    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": kernel_work.bound_ms(flops, byts, peak),
            "bound_by": kernel_work.bound_by(flops, byts, peak), "library_ms": None}


# ---------------------------------------------------------------------------
# the Oracle model stack: K5-K7 against their plain versions, and the paths
# ---------------------------------------------------------------------------

def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def model_config(name, size, **over):
    """``name`` at full width (the published config) or reduced for the CPU
    rehearsal (with the byte tokenizer's vocabulary)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import ByteTokenizer

    if size.full:
        return dataclasses.replace(get_config(name), **over)
    return get_smoke_config(name, vocab_size=ByteTokenizer().vocab_size, **over)


def entity_tables(size):
    """Two record tables of the synthetic entity corpus: every entity's
    even-numbered records on the left, its odd-numbered ones on the right."""
    from repro_torch.data.pipeline import make_entity_corpus

    records, _ = make_entity_corpus(size.entities, 8, noise=0.1, seed=SEED)
    return records[0::2], records[1::2]


def trigram_embeddings(records, d):
    """Unit rows of byte-trigram counts, each trigram hashed to one of ``d``
    columns by a fixed multiplicative hash (not Python's salted ``hash``)."""
    out = np.zeros((len(records), d), np.float32)
    for i, r in enumerate(records):
        b = np.frombuffer(f"  {r} ".encode(), np.uint8).astype(np.uint64)
        key = (b[:-2] << np.uint64(16)) | (b[1:-1] << np.uint64(8)) | b[2:]
        col = ((key * np.uint64(2654435761)) % np.uint64(2**32)) % np.uint64(d)
        np.add.at(out[i], col.astype(np.int64), 1.0)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def make_scorer(cfg, params, left, right, batch, device):
    from repro_torch.data.pipeline import ByteTokenizer, pair_example
    from repro_torch.serve import PairScorer

    tok = ByteTokenizer()

    def tok_pair(pair):
        t, _ = pair_example(tok, left[pair[0]], right[pair[1]], None, 48)
        return t[t != tok.PAD]

    return PairScorer(cfg, params, tok_pair, tok.YES, tok.NO, max_len=48,
                      batch_size=batch, device=device)


class TimedScorer:
    """A scorer whose ``score`` sums its wall time.  ``score`` ends in a copy
    to the host, so the time includes the device's work."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.seconds = 0.0

    def score(self, pairs):
        t0 = time.perf_counter()
        out = self.scorer.score(pairs)
        self.seconds += time.perf_counter() - t0
        return out


def _all_pairs(n1, n2):
    return np.stack(np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij"),
                    -1).reshape(-1, 2)


def oracle_setup(size, device, name="joinml-oracle"):
    """The Oracle path's pieces: the model ``name`` with random weights from
    the seed behind a timed ``PairScorer``, the threshold that says yes to
    the top 5% of P(match), the two record tables' catalog (byte-trigram
    embeddings) and the COUNT query."""
    from repro_torch.core import Catalog, Table
    from repro_torch.models import init_params

    cfg = model_config(name, size)
    params = init_params(cfg, seed=SEED, device=device)
    left, right = entity_tables(size)
    scorer = TimedScorer(make_scorer(cfg, params, left, right, size.batch, device))
    rng = np.random.default_rng(SEED)
    sample = np.stack([rng.integers(0, len(left), size.sample),
                       rng.integers(0, len(right), size.sample)], 1)
    thr = float(np.quantile(scorer.score(sample), THRESHOLD_Q))
    cat = Catalog()
    cat.register(Table("a", trigram_embeddings(left, EMBED_D)))
    cat.register(Table("b", trigram_embeddings(right, EMBED_D)))
    sql = ("SELECT COUNT(*) FROM a JOIN b ON NL('same entity') "
           f"ORACLE BUDGET {size.budget} WITH PROBABILITY 0.95")
    return cfg, scorer, thr, cat, left, right, sql, params


def oracle_path(size, device):
    """Phase 6, this slice's main path: a COUNT join whose Oracle is the full
    joinml-oracle on ``device`` (``ModelOracle`` over ``PairScorer``), with
    launch counts set to 0 just before ``execute`` and read just after.  The
    truth is every pair scored by the same scorer.  On the card the query
    runs once more under the profiler."""
    from repro_torch.core import JoinMLEngine, ModelOracle
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cfg, scorer, thr, cat, left, right, sql, _ = oracle_setup(size, device)
    eng = JoinMLEngine(cat, lambda nl, names: ModelOracle(scorer, thr), device=device)
    log(f"oracle path set-up: {time.perf_counter() - t0:.1f} s")

    scorer.seconds = 0.0
    batches0 = scorer.scorer.forward_batches
    cuda_lib.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    res = eng.execute(sql, seed=SEED)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    scoring_s, batches = scorer.seconds, scorer.scorer.forward_batches - batches0

    t0 = time.perf_counter()
    truth = float((scorer.score(_all_pairs(len(left), len(right))) >= thr).sum())
    truth_s = time.perf_counter() - t0
    log(json.dumps({
        "query": "Oracle COUNT", "model": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.dtype, "pairs": len(left) * len(right),
        "threshold": thr, "estimate": res.estimate, "truth": truth,
        "ci": [res.ci.lo, res.ci.hi], "covers": res.ci.contains(truth),
        "error_ratio": res.error_ratio(truth), "dispatch": res.telemetry.dispatch.path,
        "oracle_calls": res.oracle_calls, "forward_batches": batches,
        "launches": launches, "wall_s": wall, "scoring_s": scoring_s,
        "timings_s": res.telemetry.timings, "truth_scoring_s": truth_s}))
    _check_result("Oracle COUNT", res, truth)
    _check_budget("Oracle COUNT", res, size.budget)
    if size.full and device == "cuda" and res.estimate != ORACLE_COUNT_BEFORE:
        fail(f"the Oracle COUNT moved: {res.estimate!r} where it was "
             f"{ORACLE_COUNT_BEFORE!r}")
    if device == "cuda":
        if launches.get("flash_attention", 0) <= 0:
            fail("flash_attention was not launched on the Oracle path")
        scorer.seconds = 0.0
        res2, wall_ms, busy, events = _profiled(lambda: eng.execute(sql, seed=SEED + 1))
        flash = [e for e in events if "flash_attention" in e[0]]
        log(json.dumps({"profile": "Oracle COUNT", "wall_ms": wall_ms,
                        "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                        "scoring_s": scorer.seconds, "timings_s": res2.telemetry.timings,
                        "flash_attention_device_ms": sum(e[1] for e in flash),
                        "flash_attention_launches": sum(e[2] for e in flash),
                        "top_device_events": events[:8]}))
    return launches


def card_vs_cpu(size, device):
    """Phase 7: ``PairScorer.score`` with the same bf16 parameters on the
    card and on the CPU, within ``CARD_CPU_ATOL``: joinml-oracle at full
    depth, one pattern block of rwkv6-1.6b and of recurrentgemma-9b, and one
    layer of olmoe-1b-7b and of qwen3-moe-235b-a22b, all at full width (the
    MoE dispatch at 64 and 128 experts, its capacity buffer dropping
    overflow); then one encoder and one decoder layer of whisper-medium
    over its 1,500 frames (``_whisper_card_vs_cpu``)."""
    from repro_torch.models import init_params

    left, right = entity_tables(size)
    rng = np.random.default_rng(SEED + 5)
    for name, over, n in (("joinml-oracle", {}, size.cpu_pairs),
                          ("rwkv6-1.6b", {"num_layers": 1}, 4),
                          ("recurrentgemma-9b", {"num_layers": 3}, 4),
                          ("olmoe-1b-7b", {"num_layers": 1}, MOE_CPU_PAIRS),
                          ("qwen3-moe-235b-a22b", {"num_layers": 1}, MOE_CPU_PAIRS)):
        cfg = model_config(name, size, **over)
        params = init_params(cfg, seed=SEED + 1, device=device)
        pairs = np.stack([rng.integers(0, len(left), n), rng.integers(0, len(right), n)], 1)
        with _recorded_moe_routes() as card_routes:
            card_scorer = make_scorer(cfg, params, left, right, n, device)
            on_card = card_scorer.score(pairs)
        params.to("cpu")
        t0 = time.perf_counter()
        with _recorded_moe_routes() as cpu_routes:
            on_cpu = make_scorer(cfg, params, left, right, n, "cpu").score(pairs)
        cpu_s = time.perf_counter() - t0
        line = {"check": f"{name}: P(match) on the card vs the CPU",
                "layers": cfg.num_layers, "pairs": n}
        held = np.ones(n, bool)
        if cfg.family == "moe":
            excluded, line["moe"] = _route_differences(name, cfg, card_routes, cpu_routes,
                                                       _read_positions(card_scorer, pairs))
            held[sorted(excluded)] = False
        diff = float(np.abs(on_card - on_cpu)[held].max())
        log(json.dumps(line | {"max_abs_diff": diff, "tolerance": CARD_CPU_ATOL,
                               "p_range": [float(on_cpu.min()), float(on_cpu.max())],
                               "cpu_s": cpu_s}))
        if not diff <= CARD_CPU_ATOL:
            fail(f"{name}: the card's P(match) differs from the CPU's by {diff}")
        del params
        _free()
    _whisper_card_vs_cpu(size, device)


@contextlib.contextmanager
def _recorded_moe_routes():
    """Record every ``moe_mlp`` call of the port's models: its input (on
    the host, f64) and its routing as the call's own device computes it
    (the top-k experts, and the (token, choice) pairs that keep a slot of
    the capacity buffer)."""
    import repro_torch.models.model as M
    from repro_torch.models.layers import moe_route

    seen, inner = [], M.moe_mlp

    def spy(p, cfg, x):
        top_e, _, keep, _ = moe_route(p, cfg, x.reshape(-1, x.shape[-1]))
        seen.append({"x": x.double().cpu().numpy(), "top_e": top_e.cpu().numpy(),
                     "keep": keep.cpu().numpy(), "router": p.router.double().cpu().numpy()})
        return inner(p, cfg, x)

    M.moe_mlp = spy
    try:
        yield seen
    finally:
        M.moe_mlp = inner


def _read_positions(scorer, pairs):
    """The position whose logits give each pair's P(match): with one
    padded length and one batch, row i of the forward is pair i."""
    lens = np.array([len(t) for t in scorer._tokenize(pairs)])
    if len(set(scorer._buckets[np.searchsorted(scorer._buckets, lens)])) != 1:
        fail("the card-vs-CPU pairs pad to more than one length")
    return lens - 1


def _route_differences(name, cfg, card, cpu, reads):
    """Pairs a routing difference between the card and the CPU can reach,
    by the rule of the model tests: a token whose top-k set differs must be
    explained by the inputs' difference (the CPU's k-th/(k+1)-th router gap
    is at most twice the largest change of those logits), and reaches its
    own position, and every later one of its row if a layer follows.  A
    kept slot that differs where the top-k sets agree must come after a
    flipped token (a flip moves the expert's later pairs up or down the
    capacity order); with no flip the card keeps exactly the CPU's pairs.
    Fails otherwise.  Returns (rows excluded, a summary for the log)."""
    k, reach, flips = cfg.num_experts_per_tok, set(), []
    dropped = []
    for layer, (a, b) in enumerate(zip(card, cpu, strict=True)):
        rows, s = b["x"].shape[:2]
        la = a["x"].reshape(rows * s, -1) @ b["router"]
        lb = b["x"].reshape(rows * s, -1) @ b["router"]
        flip = (np.sort(a["top_e"], -1) != np.sort(b["top_e"], -1)).any(-1)
        kept_a, kept_b = (np.sort(np.where(r["keep"], r["top_e"], -1), -1) for r in (a, b))
        slot = (kept_a != kept_b).any(-1) & ~flip
        dropped.append(int((~b["keep"]).sum()))
        for t in np.nonzero(flip)[0]:
            srt = np.sort(lb[t])[::-1]
            gap, moved = float(srt[k - 1] - srt[k]), float(np.abs(la[t] - lb[t]).max())
            flips.append({"layer": layer, "pos": divmod(int(t), s), "gap": gap,
                          "logit_change": moved})
            if not gap <= 2 * moved:
                fail(f"{name}: a route differs that the inputs do not explain: {flips[-1]}")
        if slot.any() and (not flip.any() or np.nonzero(slot)[0].min()
                           <= np.nonzero(flip)[0].min()):
            fail(f"{name}: the card keeps other capacity slots than the CPU at layer {layer}")
        last = layer == len(cpu) - 1
        for t in np.nonzero(flip | slot)[0]:
            row, pos = divmod(int(t), s)
            reach |= {(row, q) for q in range(pos, pos + 1 if last else s)}
    excluded = {row for row, pos in reach if pos == reads[row]}
    if len(excluded) > len(reads) // 4:
        fail(f"{name}: routing differs at {len(excluded)} of {len(reads)} pairs")
    return excluded, {"dropped_pairs_cpu": dropped, "capacity_per_expert":
                      int(np.ceil(cpu[0]["x"].shape[0] * cpu[0]["x"].shape[1] * k
                                  / cfg.num_experts * cfg.moe_capacity_factor)),
                      "route_flips": flips, "pairs_excluded": sorted(excluded)}


def _whisper_card_vs_cpu(size, device):
    """Phase 7: whisper-medium at full width, one encoder and one decoder
    layer, over seeded (2, 1,500) frames and a ``PROMPT``-token prompt:
    the card's logits (flash attention over the frames and across them)
    within ``CARD_CPU_ATOL`` of the CPU's largest |logit|."""
    from repro_torch.models import forward, init_params

    cfg = model_config("whisper-medium", size, encoder_layers=1, num_layers=1)
    params = init_params(cfg, seed=SEED + 1, device=device)
    rng = np.random.default_rng(SEED + 13)
    batch = {"tokens": torch.from_numpy(rng.integers(8, cfg.vocab_size, (2, PROMPT))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    on_card = forward(cfg, params, batch).float().cpu()
    params.to("cpu")
    t0 = time.perf_counter()
    on_cpu = forward(cfg, params, batch).float()
    scale = float(on_cpu.abs().max())
    diff = float((on_card - on_cpu).abs().max())
    log(json.dumps({"check": "whisper-medium: logits on the card vs the CPU",
                    "encoder_layers": 1, "layers": 1, "frames": cfg.encoder_seq,
                    "tokens": PROMPT, "max_abs_diff": diff, "largest_logit": scale,
                    "tolerance": CARD_CPU_ATOL * scale,
                    "cpu_s": time.perf_counter() - t0}))
    if not diff <= CARD_CPU_ATOL * scale:
        fail(f"whisper-medium: the card's logits differ from the CPU's by {diff} "
             f"(largest {scale})")
    del params
    _free()


def recurrent_paths(size, device):
    """Phase 8: rwkv6-1.6b (K6) and recurrentgemma-9b cut to 8 layers (K7,
    and K5 in its local attention) score ``recurrent_pairs`` pairs each,
    with launch counts set to 0 just before and read just after."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params

    left, right = entity_tables(size)
    rng = np.random.default_rng(SEED + 6)
    pairs = np.stack([rng.integers(0, len(left), size.recurrent_pairs),
                      rng.integers(0, len(right), size.recurrent_pairs)], 1)
    out = {}
    for name, over, needs in (("rwkv6-1.6b", {}, ("rwkv6_scan",)),
                              ("recurrentgemma-9b", {"num_layers": RGEMMA_LAYERS},
                               ("rglru_scan", "flash_attention"))):
        cfg = model_config(name, size, **over)
        params = init_params(cfg, seed=SEED + 2, device=device)
        scorer = make_scorer(cfg, params, left, right, size.batch, device)
        cuda_lib.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        p = scorer.score(pairs)
        sync(device)
        wall = time.perf_counter() - t0
        out[name] = launches = dict(cuda_lib.LAUNCHES)
        log(json.dumps({
            "path": f"{name} scores pairs", "layers": cfg.num_layers,
            "layer_types": sorted(set(cfg.layer_types())),
            "params": sum(x.numel() for x in params.parameters()),
            "pairs": len(pairs), "forward_batches": scorer.forward_batches,
            "wall_s": wall, "pairs_per_s": len(pairs) / wall, "launches": launches,
            "p_range": [float(p.min()), float(p.max())]}))
        if not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
            fail(f"{name}: P(match) is not a probability")
        if device == "cuda":
            for k in needs:
                if launches.get(k, 0) <= 0:
                    fail(f"{k} was not launched on the {name} path")
        del params, scorer
        torch.cuda.empty_cache()
    return out


def _free():
    """Return a dropped model's memory before the next one is built: the
    big ones do not fit on the card two at a time."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _path_launches(name, launches, device, needs=("flash_attention",)):
    if device == "cuda":
        for k in needs:
            if launches.get(k, 0) <= 0:
                fail(f"{k} was not launched on the {name} path")


def _reduced_note(cfg, full_cfg):
    """What a phase-9 configuration cuts from the published one."""
    cuts = [f"{f.name} {getattr(full_cfg, f.name)} -> {getattr(cfg, f.name)}"
            for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full_cfg, f.name)]
    return cuts


def _score_pairs(name, cfg, scorer, pairs, device):
    sync(device)
    t0 = time.perf_counter()
    p = scorer.score(pairs)
    sync(device)
    wall = time.perf_counter() - t0
    if not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
        fail(f"{name}: P(match) is not a probability")
    return p, wall


def moe_oracle_path(size, device):
    """Phase 9a: olmoe-1b-7b as the Oracle.  The COUNT of phase 6 on its
    tables, held by the same checks, with launch counts set to 0 just
    before ``execute`` and read just after (the path's counts); then
    pairs/s over ``family_pairs`` pairs, the same batch scored twice (bit
    for bit), ``order_pairs`` of the truth's pairs scored again in another
    batch order (capacity counts every token of a batch, so a pair's
    P(match) depends on its batch-mates, as in the reference: the labels
    that change are reported), and requests through ``ContinuousBatcher``;
    the timed scoring's and the batcher's launches are counted apart."""
    from repro_torch.configs import get_config
    from repro_torch.core import JoinMLEngine, ModelOracle
    from repro_torch.data.pipeline import ByteTokenizer
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import ContinuousBatcher, Request

    t0 = time.perf_counter()
    cfg, scorer, thr, cat, left, right, sql, params = oracle_setup(size, device, "olmoe-1b-7b")
    eng = JoinMLEngine(cat, lambda nl, names: ModelOracle(scorer, thr), device=device)
    setup_s = time.perf_counter() - t0
    cuda_lib.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    res = eng.execute(sql, seed=SEED)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    everything = _all_pairs(len(left), len(right))
    t0 = time.perf_counter()
    p_truth = scorer.score(everything)
    truth_s = time.perf_counter() - t0
    truth = float((p_truth >= thr).sum())

    rng = np.random.default_rng(SEED + 9)
    pairs = everything[rng.choice(len(everything), size.family_pairs, replace=False)]
    cuda_lib.reset_launches()
    _, score_wall = _score_pairs("olmoe-1b-7b", cfg, scorer.scorer, pairs, device)
    scoring_launches = dict(cuda_lib.LAUNCHES)
    batch = everything[:size.batch]
    once, twice = scorer.score(batch), scorer.score(batch)
    if not np.array_equal(once, twice):
        fail("olmoe-1b-7b: the same batch scored twice differs "
             f"(max {float(np.abs(once - twice).max())})")
    # a random subset of the truth's pairs in a random order: every batch
    # holds other pairs than it did for the truth
    again = rng.choice(len(everything), size.order_pairs, replace=False)
    moved = (scorer.score(everything[again]) >= thr) != (p_truth[again] >= thr)
    flips = int(moved.sum())

    tok = ByteTokenizer()
    cb = ContinuousBatcher(cfg, params, batch_size=4, max_len=64, eos_id=tok.EOS,
                           device=device)
    for i in range(4):
        cb.submit(Request(uid=i, prompt=np.array([tok.BOS] + tok.encode(left[i])[:20],
                                                 np.int32), max_new_tokens=8))
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    done = cb.run_until_done(max_steps=200)
    sync(device)
    decode_s = time.perf_counter() - t0
    batcher_launches = dict(cuda_lib.LAUNCHES)
    if len(done) != 4 or not all(r.out_tokens for r in done):
        fail("olmoe-1b-7b: the batcher did not finish its 4 requests")
    log(json.dumps({
        "path": "phase 9: olmoe-1b-7b Oracle COUNT", "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model, "experts": cfg.num_experts,
        "top_k": cfg.num_experts_per_tok, "capacity_factor": cfg.moe_capacity_factor,
        "dtype": cfg.dtype, "params": sum(x.numel() for x in params.parameters()),
        "reduced": _reduced_note(cfg, get_config(cfg.name)),
        "pairs": len(everything), "threshold": thr, "estimate": res.estimate,
        "truth": truth, "ci": [res.ci.lo, res.ci.hi], "covers": res.ci.contains(truth),
        "error_ratio": res.error_ratio(truth), "dispatch": res.telemetry.dispatch.path,
        "oracle_calls": res.oracle_calls, "set_up_s": setup_s, "wall_s": wall, "truth_scoring_s": truth_s,
        "scored_pairs": len(pairs), "pairs_per_s": len(pairs) / score_wall,
        "scoring_launches": scoring_launches,
        "same_batch_bit_identical": True,
        "rescored_in_another_order": len(again),
        "labels_changed_by_batch_order": flips,
        "batcher": {"requests": len(done), "tokens": sum(len(r.out_tokens) for r in done),
                    "wall_s": decode_s, "launches": batcher_launches},
        "launches": launches}))
    _check_result("olmoe-1b-7b Oracle COUNT", res, truth)
    _check_budget("olmoe-1b-7b Oracle COUNT", res, size.budget)
    _path_launches("olmoe-1b-7b", launches, device)
    _path_launches("olmoe-1b-7b scoring", scoring_launches, device)
    return launches


def family_scoring(name, size, device, needs=("flash_attention",), **over):
    """Phase 9b/9c/9e: ``name`` (cut by ``over``) scores ``family_pairs``
    pairs, with launch counts set to 0 just before and read just after
    (each of ``needs`` launched at least once); also returns the
    parameters for a forward of its own."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params

    left, right = entity_tables(size)
    rng = np.random.default_rng(SEED + 10)
    pairs = np.stack([rng.integers(0, len(left), size.family_pairs),
                      rng.integers(0, len(right), size.family_pairs)], 1)
    cfg = model_config(name, size, **over)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED + 3, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    scorer = make_scorer(cfg, params, left, right, size.batch, device)
    cuda_lib.reset_launches()
    p, wall = _score_pairs(name, cfg, scorer, pairs, device)
    launches = dict(cuda_lib.LAUNCHES)
    log(json.dumps({
        "path": f"phase 9: {name} scores pairs", "layers": cfg.num_layers,
        "d_model": cfg.d_model, "params": sum(x.numel() for x in params.parameters()),
        "reduced": _reduced_note(cfg, get_config(name)), "init_s": init_s,
        "pairs": len(pairs), "forward_batches": scorer.forward_batches, "wall_s": wall,
        "pairs_per_s": len(pairs) / wall, "launches": launches,
        "p_range": [float(p.min()), float(p.max())]}))
    _path_launches(name, launches, device, needs)
    del scorer
    return cfg, params, launches


def vlm_forward(cfg, params, size, device):
    """Phase 9c: pixtral-12b's forward over seeded patches before a
    ``PROMPT``-token prompt, counts set to 0 just before and read after."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import forward

    rng = np.random.default_rng(SEED + 11)
    b = size.family_batch
    batch = {"tokens": torch.from_numpy(rng.integers(8, cfg.vocab_size, (b, PROMPT))),
             "patches": torch.from_numpy(rng.standard_normal(
                 (b, cfg.num_patches, cfg.d_model)).astype(np.float32))}
    cuda_lib.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    logits = forward(cfg, params, batch)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    ok = bool(torch.isfinite(logits).all())
    log(json.dumps({"path": f"phase 9: {cfg.name} forward with patches",
                    "batch": b, "patches": cfg.num_patches, "tokens": PROMPT,
                    "logits": list(logits.shape), "finite": ok, "wall_s": wall,
                    "launches": launches}))
    if logits.shape != (b, cfg.num_patches + PROMPT, cfg.vocab_size) or not ok:
        fail(f"{cfg.name}: logits of shape {tuple(logits.shape)}, finite {ok}")
    _path_launches(cfg.name, launches, device)
    return launches


def encdec_path(size, device):
    """Phase 9d: whisper-medium's forward over seeded frames and a
    ``PROMPT``-token prompt (``prefill``, which returns a fresh cache as the
    reference's does), then ``decode_steps`` greedy decode steps from
    position 0; counts set to 0 just before and read after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import decode_step, init_params, prefill

    cfg = model_config("whisper-medium", size)
    params = init_params(cfg, seed=SEED + 4, device=device)
    rng = np.random.default_rng(SEED + 12)
    b = size.family_batch
    batch = {"tokens": torch.from_numpy(rng.integers(8, cfg.vocab_size, (b, PROMPT))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    cuda_lib.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, max_len=PROMPT + size.decode_steps)
    sync(device)
    forward_s = time.perf_counter() - t0
    tok = logits[:, -1].argmax(-1)[:, None]
    steps = []
    for t in range(size.decode_steps):
        sync(device)
        t0 = time.perf_counter()
        step_logits, cache = decode_step(cfg, params, cache, tok, t)
        tok = step_logits.argmax(-1)[:, None]
        sync(device)
        steps.append(time.perf_counter() - t0)
    launches = dict(cuda_lib.LAUNCHES)
    ok = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    log(json.dumps({"path": "phase 9: whisper-medium forward and decode",
                    "encoder_layers": cfg.encoder_layers, "layers": cfg.num_layers,
                    "params": sum(x.numel() for x in params.parameters()),
                    "reduced": _reduced_note(cfg, get_config(cfg.name)),
                    "batch": b, "frames": cfg.encoder_seq, "tokens": PROMPT,
                    "forward_s": forward_s, "decode_steps": len(steps),
                    "decode_step_ms": [1e3 * x for x in steps],
                    "decode_step_ms_median": 1e3 * float(np.median(steps)),
                    "finite": ok, "launches": launches}))
    if logits.shape != (b, PROMPT, cfg.vocab_size) or not ok:
        fail(f"whisper-medium: logits of shape {tuple(logits.shape)}, finite {ok}")
    _path_launches("whisper-medium", launches, device)
    return launches


def family_paths(size, device):
    """Phase 9: the MoE, VLM and encoder-decoder families on ``device``,
    one model at a time.  Returns {path: launch counts}."""
    paths = {"olmoe-1b-7b (9)": moe_oracle_path(size, device)}
    _free()
    _, params, paths["qwen3-moe-235b-a22b (9)"] = family_scoring(
        "qwen3-moe-235b-a22b", size, device,
        **({"num_layers": QWEN3_LAYERS} if size.full else {}))
    del params
    _free()
    cfg, params, paths["pixtral-12b pairs (9)"] = family_scoring("pixtral-12b", size, device)
    paths["pixtral-12b patches (9)"] = vlm_forward(cfg, params, size, device)
    del params
    _free()
    paths["whisper-medium (9)"] = encdec_path(size, device)
    _free()
    paths["moonlight-16b-a3b (9)"] = moonlight_path(size, device)
    return paths


def moonlight_path(size, device):
    """Phase 9e: moonlight-16b-a3b whole (latent attention through K5 at q/k
    192 against v 128, the sigmoid router with its bias, shared experts,
    the dropless dispatch; reduced on the CPU) scores ``family_pairs``
    pairs.  Returns its launch counts."""
    _, params, launches = family_scoring("moonlight-16b-a3b", size, device, needs=(LATENT,),
                                         moe_capacity_factor=0.0)
    del params
    _free()
    return launches


# (B, Hq, Hkv, Sq, Skv, d, causal, window[, dv]), bf16 as the models run it;
# dv, v's and the output's width, where it differs from q's and k's d (the
# latent attention's (192, 128), counted as ``flash_attention_192_128``).  The
# rows named "path" are shapes the main paths give the kernel (the entity
# pairs are 35-45 tokens, so every batch is padded to the 48-token bucket);
# phase 9's forwards follow (pixtral's 256 patches before a 48-token prompt,
# whisper's encoder over its 1,500 frames and the decoder's cross-attention
# over them, neither causal), then the scorer's 16-token bucket, the long
# shapes, and Moonlight's latent widths at its scorer's 64-, 32- and 16-token
# buckets (phase 9e).  The first row is the Oracle path's.
FLASH_SHAPES = {
    "joinml-oracle path": (256, 12, 12, 48, 48, 64, True, 0),
    "recurrentgemma-9b path": (256, 16, 1, 48, 48, 256, True, 2048),
    "olmoe-1b-7b path": (256, 16, 16, 48, 48, 128, True, 0),
    "qwen3-moe heads path": (256, 64, 4, 48, 48, 128, True, 0),
    "pixtral-12b, 256 patches + 48 tokens": (4, 32, 8, 304, 304, 128, True, 0),
    "whisper-medium encoder": (4, 16, 16, 1500, 1500, 64, False, 0),
    "whisper-medium cross-attention": (4, 16, 16, 48, 1500, 64, False, 0),
    "joinml-oracle, 16-token bucket": (256, 12, 12, 16, 16, 64, True, 0),
    "llama3.2-1b heads, S 4096": (1, 32, 8, 4096, 4096, 64, True, 0),
    "recurrentgemma heads, S 4096, window 2048": (1, 16, 1, 4096, 4096, 256, True, 2048),
    "moonlight-16b-a3b path": (256, 16, 16, 64, 64, 192, True, 0, 128),
    "moonlight-16b-a3b, 32-token bucket": (256, 16, 16, 32, 32, 192, True, 0, 128),
    "moonlight-16b-a3b, 16-token bucket": (256, 16, 16, 16, 16, 192, True, 0, 128),
}
# (B, H, T, hd); K6 runs them on bf16 (B, T, H, hd) projections as the model
# holds them, then on f32 (B, H, T, hd) operands
RWKV_SHAPES = {"rwkv6-1.6b path": (256, 32, 48, 64), "T 4096": (1, 32, 4096, 64)}
RGLRU_SHAPES = {"recurrentgemma-9b path": (256, 48, 4096), "T 4096": (1, 4096, 4096)}


def _flash_widths(shape):
    """(d, dv) of a ``FLASH_SHAPES`` entry."""
    return shape[5], shape[8] if len(shape) > 8 else shape[5]


def _flash_case(gen, shape, dtype=torch.bfloat16):
    import torch.nn.functional as F

    from repro_torch.kernels import checks
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.roofline import kernel_work

    b, hq, hkv, sq, skv, d, causal, window = shape[:8]
    dv = _flash_widths(shape)[1]
    q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, skv, dv), generator=gen, device="cuda").to(dtype)
    if window:
        qp = torch.arange(sq, device="cuda")[:, None]
        kp = torch.arange(skv, device="cuda")[None, :]
        mask = (qp >= kp) & (qp - kp < window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    return (lambda: flash_attention_cuda(q, k, v, causal=causal, window=window),
            lambda: flash_attention_ref(q, k, v, causal=causal, window=window),
            lambda: checks.flash_attention_bound(q, k, v, causal=causal, window=window),
            library, *kernel_work.work("flash_attention", b=b, hq=hq, hkv=hkv, sq=sq, skv=skv,
                                       d=d, causal=causal, window=window, dtype=dtype,
                                       dv=dv))


def _flash_f32_case(gen, shape):
    """K5 at f32 (the SIMT kernel: no TF32 on an f32 path), against the f32
    peak of the CUDA cores."""
    return _flash_case(gen, shape, torch.float32)


def _rwkv_case(gen, shape, model_layout=True):
    """K6 as the model calls it (bf16 r, k, v and f32 w as (B, H, T, hd)
    views of (B, T, H, hd) projections), or on f32 (B, H, T, hd) operands,
    with its work (``kernel_work.rwkv6_scan``)."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.roofline import kernel_work

    b, h, t, hd = shape
    dims = (b, t, h, hd) if model_layout else (b, h, t, hd)
    view = (lambda z: z.transpose(1, 2)) if model_layout else (lambda z: z)  # noqa: E731
    dtype = torch.bfloat16 if model_layout else torch.float32
    r, k, v = (view(torch.randn(dims, generator=gen, device="cuda").to(dtype))
               for _ in range(3))
    # the model's decays: exp(-exp(w0 + ...)) with w0 = -6
    w = view(torch.exp(-torch.exp(torch.empty(dims, device="cuda")
                                  .uniform_(-8.0, -4.0, generator=gen))))
    u = 0.1 * torch.randn((h, hd), generator=gen, device="cuda")
    return (lambda: rwkv6_scan_cuda(r, k, v, w, u),
            lambda: rwkv6_scan_ref(r, k, v, w, u),
            lambda: checks.rwkv6_scan_bound(r, k, v, w, u),
            None, *kernel_work.work("rwkv6_scan", b=b, h=h, t=t, hd=hd, dtype=dtype))


def _rwkv_f32_case(gen, shape):
    return _rwkv_case(gen, shape, model_layout=False)


def _rglru_case(gen, shape):
    from repro_torch.kernels import checks
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.roofline import kernel_work

    b, t, r = shape
    # the model's gates: a in (0, 1), g scaled by sqrt(1 - a^2)
    a = torch.empty((b, t, r), device="cuda").uniform_(0.5, 0.9999, generator=gen)
    g = torch.sqrt(1 - a * a) * torch.randn((b, t, r), generator=gen, device="cuda")
    return (lambda: rglru_scan_cuda(a, g), lambda: rglru_scan_ref(a, g),
            lambda: checks.rglru_scan_bound(a, g),
            None, *kernel_work.work("rglru_scan", b=b, t=t, r=r))


def model_kernel_row(name, model_rows, paths):
    """A model kernel's row of the final ``kernels`` line: its first shape's
    times and check (:func:`model_kernels`), its launches on its main path
    (``MAIN_PATH``) and on each of ``paths``, its other shapes."""
    path_row, *other_rows = model_rows[name]
    return {"name": name, "route": "cuda", "source": MODEL_SOURCE,
            "replaces": REPLACES[name], "launches": paths[MAIN_PATH[name]].get(name, 0),
            **path_row, "launches_by_path": {p: n.get(name, 0) for p, n in paths.items()},
            "other_shapes": other_rows}


def latent_kernels():
    """K5 at latent attention's widths alone (``flash_attention_192_128``):
    its phase-3b rows, Moonlight's phase-9e path, then its row of the final
    ``kernels`` line.  ``python -c 'import chip_smoke as c;
    c.latent_kernels()'`` on a card."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.build()
    rows = model_kernels(kernels=(LATENT,))
    paths = {MAIN_PATH[LATENT]: moonlight_path(FULL_MODEL, "cuda")}
    row = model_kernel_row(LATENT, rows, paths)
    log(json.dumps({"kernels": [row]}))
    return row


def model_kernels(kernels=None):
    """Phase 3b: K5-K7 against their plain versions under
    ``checks.check_model_kernel`` (twice the f32 error bound of the
    function, plus half a bf16 ulp on each side) at each shape, then their
    times (CUDA events), beside the bound and, for attention, the yardstick
    ``scaled_dot_product_attention`` (timed here only; the port never calls
    it).  K5 runs at every shape in bf16 (the tensor-core kernel, as the
    models run it) and then at the equal widths in f32 (the SIMT kernel).
    Returns {kernel: [row per shape]}, the first path shape first, K5's
    rows under their launch names (``kernel.launch_name``: the latent
    widths apart); ``kernels``: only the rows of these names."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.flash_attention.kernel import launch_name

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    def cases(shapes, case):
        return {label: (shape, case) for label, shape in shapes.items()}

    f32_shapes = {f"{label}, f32": shape for label, shape in FLASH_SHAPES.items()
                  if len(set(_flash_widths(shape))) == 1}
    rwkv_f32 = {f"{label}, f32 (B, H, T, hd)": shape for label, shape in RWKV_SHAPES.items()}
    for name, shape_cases in (
            ("flash_attention", cases(FLASH_SHAPES, _flash_case)
             | cases(f32_shapes, _flash_f32_case)),
            ("rwkv6_scan", cases(RWKV_SHAPES, _rwkv_case) | cases(rwkv_f32, _rwkv_f32_case)),
            ("rglru_scan", cases(RGLRU_SHAPES, _rglru_case))):
        for label, (shape, case) in shape_cases.items():
            key = launch_name(*_flash_widths(shape)) if name == "flash_attention" else name
            if kernels is not None and key not in kernels:
                continue
            kern, plain, bound, library, flops, byts, peak = case(gen, shape)
            got = kern()
            torch.cuda.synchronize()
            rule = checks.check_model_kernel(got, plain(), bound())
            del got
            path = "path" in label
            row = _row(_events_ms(kern, 20 if path else 5), _events_ms(plain, 1),
                       flops, byts, peak)
            if library is not None:
                row["library_ms"] = _events_ms(library, 20 if path else 5)
            if library is None:
                row["library_note"] = "no one PyTorch call computes the recurrence"
            row.update(shape=label, dims=list(shape), **rule)
            log(json.dumps({"check": key, **row}))
            rows.setdefault(key, []).append(row)
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3c: K5's backward against its plain version
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, d, causal, window, dtype): the training shape (phase
# 11's joinml-oracle batch) in bf16 and in f32, then the other families'
# attention: qwen3's GQA 16:1 heads at d 128, recurrentgemma's windowed MQA
# at S 4096, whisper's encoder and its decoder's cross-attention (448 target
# tokens against 1,500 frames), and a ragged Sq of 100
FLASH_BWD_SHAPES = {
    "joinml-oracle training": (16, 12, 12, 128, 128, 64, True, 0, torch.bfloat16),
    "joinml-oracle training, f32": (16, 12, 12, 128, 128, 64, True, 0, torch.float32),
    "qwen3-moe heads (GQA 16:1, d 128)": (16, 64, 4, 128, 128, 128, True, 0, torch.bfloat16),
    "recurrentgemma heads, S 4096, window 2048": (1, 16, 1, 4096, 4096, 256, True, 2048,
                                                  torch.bfloat16),
    "whisper-medium encoder": (4, 16, 16, 1500, 1500, 64, False, 0, torch.bfloat16),
    "whisper-medium cross-attention, 448 x 1500": (4, 16, 16, 448, 1500, 64, False, 0,
                                                   torch.bfloat16),
    "joinml-oracle heads, ragged Sq 100": (16, 12, 12, 100, 100, 64, True, 0, torch.bfloat16),
    "recurrentgemma training (MQA 16:1, d 256)": (8, 16, 1, 128, 128, 256, True, 2048,
                                                  torch.bfloat16),
}
TRAIN_SHAPE = "joinml-oracle training"
# the scans' backwards at phase 11's training shapes: K6 (B, H, T, hd) with
# bf16 r, k, v in the model's (B, T, H, hd) layout, K7 (B, T, R)
RWKV_BWD_SHAPE = ("rwkv6-1.6b training", (16, 32, 128, 64))
# K6's backward also at few heads over a long sequence: 32 clusters of 4 CTAs
RWKV_BWD_OTHER_SHAPES = {"few heads, T 4096": (1, 32, 4096, 64)}
RGLRU_BWD_SHAPE = ("recurrentgemma-9b training", (8, 128, 4096))


def _sdpa_grad_fns(q, k, v, do, causal, window):
    """SDPA's forward + backward and its backward alone (``retain_graph``),
    the library's yardstick for K5's backward (timed here only)."""
    import torch.nn.functional as F

    sq, skv = q.shape[2], k.shape[2]
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
    kw = {"enable_gqa": True}
    if window:
        qp = torch.arange(sq, device="cuda")[:, None]
        kp = torch.arange(skv, device="cuda")[None, :]
        kw["attn_mask"] = (qp >= kp) & (qp - kp < window)
    else:
        kw["is_causal"] = causal

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qa, ka, va, **kw)
        return torch.autograd.grad(out, (qa, ka, va), do)

    held = F.scaled_dot_product_attention(qa, ka, va, **kw)
    return fwd_bwd, lambda: torch.autograd.grad(held, (qa, ka, va), do, retain_graph=True)


def flash_backward():
    """Phase 3c: K5's backward (``flash_attention_bwd_cuda``) at each
    ``FLASH_BWD_SHAPES`` entry against an f64 autograd of the plain version
    under ``checks.flash_attention_grad_bound`` (``check_model_kernel``), a
    second run equal bit for bit, and its times (CUDA events) beside the
    plain version's backward (autograd through ``flash_attention_ref``), our
    forward + backward, SDPA's forward + backward and its backward alone,
    and the bound (``kernel_work.flash_attention_bwd``: 2.5 times the
    forward's operations over the unmasked pairs against the peak of the
    input type, or the bytes of q, k, v, o, dO and the lse read, dq, dk, dv
    written).  Returns the row per shape, the training shape's first."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.roofline import kernel_work

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, (b, hq, hkv, sq, skv, d, causal, window, dt) in FLASH_BWD_SHAPES.items():
        q, do = (torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, skv, d), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        kern = lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, causal, window)  # noqa: E731
        got, again = kern(), kern()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
        want = torch.autograd.grad(flash_attention_ref(qd, kd, vd, causal, window),
                                   (qd, kd, vd), do.double())
        del qd, kd, vd
        bounds = checks.flash_attention_grad_bound(q, k, v, do, causal, window)
        rules = {name: checks.check_model_kernel(g, w, e)
                 for name, g, w, e in zip(("dq", "dk", "dv"), got, want, bounds)}
        del got, want, bounds
        torch.cuda.empty_cache()
        qp_, kp_, vp_ = (t.detach().clone().requires_grad_() for t in (q, k, v))
        held = flash_attention_ref(qp_, kp_, vp_, causal, window)
        plain = lambda: torch.autograd.grad(held, (qp_, kp_, vp_), do, retain_graph=True)  # noqa: E731

        def ours():
            o2, l2 = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
            return flash_attention_bwd_cuda(q, k, v, o2, do, l2, causal, window)

        sdpa, sdpa_bwd = _sdpa_grad_fns(q, k, v, do, causal, window)
        reps = 10 if sq * skv <= 1 << 16 else 3
        row = _row(_events_ms(kern, reps), _events_ms(plain, 1),
                   *kernel_work.work("flash_attention_bwd", b=b, hq=hq, hkv=hkv, sq=sq,
                                     skv=skv, d=d, causal=causal, window=window, dtype=dt))
        row.update(fwd_bwd_ms=_events_ms(ours, reps), library_ms=_events_ms(sdpa, reps),
                   library_note="scaled_dot_product_attention forward + backward",
                   library_bwd_ms=_events_ms(sdpa_bwd, reps), shape=label,
                   share=row["bound_ms"] / row["ms"],
                   dims=[b, hq, hkv, sq, skv, d, causal, window, str(dt)[6:]],
                   same_bits_twice=same,
                   max_abs_err=max(r["max_abs_err"] for r in rules.values()),
                   err_over_tol={k_: r["err_over_tol"] for k_, r in rules.items()})
        log(json.dumps({"check": "flash_attention_bwd", **row}))
        if not same:
            fail(f"K5's backward gave other bits on a second run at {label}")
        rows.append(row)
        del q, k, v, do, o, lse, held, qp_, kp_, vp_
        torch.cuda.empty_cache()
    return rows


def _grad_row(name, label, dims, kern, plain, exact, bounds, work):
    """A backward kernel ``kern`` (a tuple of gradients) against ``exact()``
    (f64) under ``bounds()`` (``check_model_kernel``), a second run equal bit
    for bit, and its time beside the plain version's and the bound of its
    ``work`` (``kernel_work.work``'s (operations, bytes, peak))."""
    from repro_torch.kernels import checks

    got, again = kern(), kern()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    rules = [checks.check_model_kernel(g, w, e) for g, w, e in zip(got, exact(), bounds())]
    del got
    torch.cuda.empty_cache()
    row = _row(_events_ms(kern, 10), _events_ms(plain, 1), *work)
    row.update(share=row["bound_ms"] / row["ms"], shape=label, dims=list(dims),
               same_bits_twice=same, max_abs_err=max(r["max_abs_err"] for r in rules),
               err_over_tol=max(r["err_over_tol"] for r in rules),
               library_note="no one PyTorch call computes the recurrence's gradient")
    log(json.dumps({"check": name, **row}))
    if not same:
        fail(f"{name} gave other bits on a second run at {label}")
    torch.cuda.empty_cache()
    return row


def scan_backwards():
    """Phase 3c, the scans: K6's backward at phase 11's rwkv6-1.6b shape (bf16
    r, k, v and f32 w as views of (B, T, H, hd) tensors, the model's decays)
    and K7's at recurrentgemma-9b's, each against an f64 autograd of the
    plain forward under ``checks.*_scan_grad_bound``, bit for bit on a
    second run, beside the plain backward (``*_scan_bwd_ref``) and the bound
    (K6 also at ``RWKV_BWD_OTHER_SHAPES``, its row's ``other_shapes``;
    ``kernel_work.rwkv6_scan_bwd`` and ``rglru_scan_bwd``).  Returns
    {kernel: row}."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd_cuda, rglru_scan_cuda
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_cuda
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
    from repro_torch.roofline import kernel_work

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    k6_rows = []
    for label, (b, h, t, hd) in [RWKV_BWD_SHAPE, *RWKV_BWD_OTHER_SHAPES.items()]:
        # the other shapes draw from a generator of their own, so that the
        # training shape's and K7's inputs stay as they were
        g6 = gen if label == RWKV_BWD_SHAPE[0] else torch.Generator(
            device="cuda").manual_seed(SEED + 1)
        model = lambda z: z.transpose(1, 2)  # noqa: E731
        r, k, v = (model(torch.randn((b, t, h, hd), generator=g6, device="cuda")
                         .to(torch.bfloat16)) for _ in range(3))
        w = model(torch.exp(-torch.exp(torch.empty((b, t, h, hd), device="cuda")
                                       .uniform_(-8.0, -4.0, generator=g6))))
        u = 0.1 * torch.randn((h, hd), generator=g6, device="cuda")
        do = model(torch.randn((b, t, h, hd), generator=g6, device="cuda"))
        xs = (r, k, v, w, u)

        def rwkv_exact(xs=xs, do=do):
            xd = [x.double().requires_grad_() for x in xs]
            return torch.autograd.grad(rwkv6_scan_ref(*xd), xd, do.double(),
                                       materialize_grads=True)

        k6_rows.append(_grad_row(
            "rwkv6_scan_bwd", label, (b, h, t, hd),
            lambda xs=xs, do=do: rwkv6_scan_bwd_cuda(*xs, do),
            lambda xs=xs, do=do: rwkv6_scan_bwd_ref(*xs, do), rwkv_exact,
            lambda xs=xs, do=do: checks.rwkv6_scan_grad_bound(*xs, do),
            kernel_work.work("rwkv6_scan_bwd", b=b, h=h, t=t, hd=hd, dtype=r.dtype)))
        del r, k, v, w, u, do, xs, rwkv_exact
        torch.cuda.empty_cache()
    rows["rwkv6_scan_bwd"] = {**k6_rows[0], "other_shapes": k6_rows[1:]}

    label, (b, t, rr) = RGLRU_BWD_SHAPE
    a = torch.empty((b, t, rr), device="cuda").uniform_(0.5, 0.9999, generator=gen)
    g = torch.sqrt(1 - a * a) * torch.randn((b, t, rr), generator=gen, device="cuda")
    do = torch.randn((b, t, rr), generator=gen, device="cuda")
    hs = rglru_scan_cuda(a, g)

    def lru_exact():
        ad, gd = a.double().requires_grad_(), g.double().requires_grad_()
        return torch.autograd.grad(rglru_scan_ref(ad, gd), (ad, gd), do.double())

    rows["rglru_scan_bwd"] = _grad_row(
        "rglru_scan_bwd", label, (b, t, rr), lambda: rglru_scan_bwd_cuda(a, hs, do),
        lambda: rglru_scan_bwd_ref(a, hs, do), lru_exact,
        lambda: checks.rglru_scan_grad_bound(a, g, do),
        kernel_work.work("rglru_scan_bwd", b=b, t=t, r=rr))
    return rows


# ---------------------------------------------------------------------------
# phase 3d: K8, the bootstrap-t's resampling
# ---------------------------------------------------------------------------

BOOT_SOURCE = "src/repro_torch/csrc/bootstrap_kernels.cu"
BOOT_REPLACES = ("none: the reference draws its resamples with numpy's Generator and "
                 "reduces them on the host (src/repro/core/bootstrap.py:56-80)")
BOOT_KERNELS = ("bootstrap_detect", "bootstrap_moments", "bootstrap_reduce")
# the labels cell's bootstrap: 16 strata of 1,000 sampled pairs, 1,000 resamples
BOOT_STRATA, BOOT_SAMPLES, BOOT_RESAMPLES = 16, 1000, 1000


def bootstrap_kernels():
    """Phase 3d: K8 against its plain NumPy version (``kernels/plain.py``)
    at the labels cell's shape, COUNT and AVG: the Generator's state after
    and the rejections equal, the moments within 1e-10 of each row's
    largest, the card's twice bit for bit.  Then its kernels' device time a
    call (torch.profiler: the three kernels summed), the whole call's wall
    time (host clock: copies and the host's rejection walk included), the
    plain version's, and the bound of ``kernel_work.bootstrap``.  Returns
    [COUNT's row, AVG's row]."""
    from repro_torch.kernels import plain
    from repro_torch.kernels.bootstrap_t.kernel import resample_moments_cuda
    from repro_torch.roofline import kernel_work

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    st, ct = [], []
    for _ in range(BOOT_STRATA):
        n = BOOT_SAMPLES
        o = (rng.random(n) < 0.4).astype(float)
        q = rng.dirichlet(np.ones(n)) + 1e-6
        s_t, c_t = rng.lognormal(1.0, 0.7, n) * o / q, o / q
        st.append(s_t - s_t.mean())
        ct.append(c_t - c_t.mean())
    state = np.random.default_rng(SEED + 1).bit_generator.state
    draws = BOOT_STRATA * BOOT_SAMPLES * BOOT_RESAMPLES
    rows = []
    for agg, flags, arrays in (("COUNT", plain.MOMENT_COUNT, 1), ("AVG", 7, 2)):
        terms = (st if flags & plain.MOMENT_SUM else None,
                 ct if flags & plain.MOMENT_COUNT else None)

        def card(terms=terms, flags=flags):
            return resample_moments_cuda(*terms, BOOT_RESAMPLES, state, flags, dev)

        t0 = time.perf_counter()
        want, want_state, want_rej = plain.resample_moments_plain(*terms, BOOT_RESAMPLES,
                                                                  state, flags)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got, got_state, got_rej = card()
        again = card()[0]
        if got_state != want_state or got_rej != want_rej:
            fail(f"bootstrap {agg}: the card's draws are not the Generator's")
        if not np.array_equal(got, again):
            fail(f"bootstrap {agg}: two runs on the card differ")
        scale = np.abs(want).max(axis=1, keepdims=True)
        err = float((np.abs(got - want) / np.where(scale > 0, scale, 1.0)).max())
        if err > 1e-10:
            fail(f"bootstrap {agg}: moments {err:.3g} from the plain version's")
        by_kernel = device_ms_by_kernel(card, 5)
        kernel_ms = sum(v for k, v in by_kernel.items() if "boot_" in k)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            card()
            walls.append((time.perf_counter() - t0) * 1e3)
        flops, byts, peak = kernel_work.work("bootstrap", draws=draws,
                                             samples=BOOT_STRATA * BOOT_SAMPLES,
                                             n_boot=BOOT_RESAMPLES, arrays=arrays)
        row = _row(kernel_ms, plain_ms, flops, byts, peak)
        row.update(shape=f"{agg}: {BOOT_STRATA} strata x {BOOT_SAMPLES} samples, n_boot "
                         f"{BOOT_RESAMPLES}", call_ms=float(np.median(walls)),
                   call_ms_range=[min(walls), max(walls)], rejections=got_rej,
                   max_rel_err=err, by_kernel_ms=by_kernel,
                   library_note="no PyTorch call replays numpy's Generator")
        log(json.dumps({"check": "bootstrap", **row}))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 11: training joinml-oracle at full width
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainSize:
    full: bool        # the published config (else the reduced one)
    batch: int        # sequences of a step
    seq: int          # tokens of a sequence
    steps: int        # steps on the repeated batch
    launcher_steps: int


TRAIN_FULL = TrainSize(full=True, batch=16, seq=128, steps=12, launcher_steps=4)
TRAIN_REHEARSAL = TrainSize(full=False, batch=4, seq=32, steps=6, launcher_steps=2)
TRAIN_LR = 1e-4
# phase 11b: the recurrent families, one on the card at a time: (arch,
# config cuts, sequences of a step at full width); rwkv6-1.6b in full,
# recurrentgemma-9b at full width cut to 8 of 38 layers as phase 8 cuts it
# (weights, gradients and f32 moments of all 38 take ~125 GB); the
# rehearsal takes the reduced configs at TRAIN_REHEARSAL's batch
RECURRENT_TRAIN = (("rwkv6-1.6b", {}, 16),
                   ("recurrentgemma-9b", {"num_layers": RGEMMA_LAYERS}, 8))
RECURRENT_TRAIN_STEPS = 6


def _train_setup(size, device, seed=SEED, name=None, over=None, batch=None, with_opt=True):
    """``name`` (joinml-oracle unless named; remat on, as published), AdamW
    (its zero state unless ``with_opt`` is false), and a loader of ``batch``
    (else ``size.batch``) pair sequences from the entity corpus
    (``make_pair_batch``, loss on the label token)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import ByteTokenizer, make_entity_corpus, make_pair_batch
    from repro_torch.models import init_params
    from repro_torch.train import OptimizerConfig, init_opt_state

    tok = ByteTokenizer()
    name = name or ORACLE_NAME
    cfg = dataclasses.replace(get_config(name), remat=True, **(over or {})) if size.full \
        else get_smoke_config(name, vocab_size=tok.vocab_size, remat=True,
                              **{k: v for k, v in (over or {}).items() if k == "dtype"})
    batch = batch or size.batch
    params = init_params(cfg, seed, device=device)
    opt = init_opt_state(params) if with_opt else None
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=2, decay_steps=1000)
    records, ids = make_entity_corpus(n_entities=64, records_per_entity=4, noise=0.08,
                                      seed=seed)

    def batch_at(step):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        b = make_pair_batch(tok, records, ids, batch, size.seq, rng)
        return {"tokens": b["tokens"], "loss_mask": b["loss_mask"]}

    return cfg, params, opt, ocfg, batch_at


def resume_check(device, full):
    """3 steps, a save through ``AsyncCheckpointer``, a restore into other
    parameters, 3 more steps; against 6 uninterrupted steps, every
    parameter and moment bit for bit.  Run in its own process under
    ``torch.use_deterministic_algorithms(True)``; prints one JSON line."""
    import tempfile

    from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, restore_latest
    from repro_torch.train import make_train_step

    torch.use_deterministic_algorithms(True)
    size = TRAIN_FULL if full else TRAIN_REHEARSAL
    cfg, p, o, ocfg, batch_at = _train_setup(size, device)
    step_fn = make_train_step(cfg, ocfg)
    for s in range(6):
        p, o, _ = step_fn(p, o, batch_at(s))
    ref = {k: t.detach().clone() for k, t in p.state_dict().items()}
    ref_m = {k: t.clone() for k, t in o["m"].items()}
    ref_v = {k: t.clone() for k, t in o["v"].items()}
    del p, o
    cfg, p2, o2, _, _ = _train_setup(size, device)
    for s in range(3):
        p2, o2, _ = step_fn(p2, o2, batch_at(s))
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as root:
        ck = AsyncCheckpointer(root, keep_last=1)
        ck.save(3, {"params": p2, "opt": o2})
        ck.wait()
        del p2, o2
        _, p3, o3, _, _ = _train_setup(size, device, seed=SEED + 1)
        (tree, manifest) = restore_latest(root, {"params": p3, "opt": o3})
    p3, o3 = tree["params"], tree["opt"]
    for s in range(3, 6):
        p3, o3, _ = step_fn(p3, o3, batch_at(s))
    sync(device)
    diff = [k for k, t in p3.state_dict().items() if not torch.equal(t, ref[k])]
    diff += [f"m/{k}" for k, t in o3["m"].items() if not torch.equal(t, ref_m[k])]
    diff += [f"v/{k}" for k, t in o3["v"].items() if not torch.equal(t, ref_v[k])]
    print(json.dumps({"resume": "3 + save + restore + 3 against 6 steps",
                      "restored_step": manifest["step"], "step": int(o3["step"]),
                      "leaves": len(ref) + len(ref_m) + len(ref_v),
                      "differing": diff[:8], "equal": not diff}), flush=True)


def _subprocess_resume(device, size):
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.path.join(HERE, "src"))
    code = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            "chip_smoke.resume_check({device!r}, {full!r})").format(
                here=HERE, device=device, full=size.full)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=HERE, env=env, timeout=900)
    if out.returncode != 0:
        fail(f"the resume check exited {out.returncode} (an op that refuses to run "
             f"under deterministic algorithms is named here):\n{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["wall_s"] = time.perf_counter() - t0
    log(json.dumps(res))
    if not res["equal"]:
        fail(f"the resumed run differs from the uninterrupted one: {res['differing']}")


def _train_launcher(device, size):
    """The training launcher as a subprocess: started twice on one
    checkpoint directory, the second start resuming where the first
    stopped; then ``--arch rwkv6-1.6b`` for two steps of the reduced config
    (K6 and its backward)."""
    import shutil as _shutil

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))

    def run(label, args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                              "--device", device], capture_output=True, text=True,
                             cwd=HERE, env=env, timeout=600)
        log(json.dumps({"train launcher": label, "rc": out.returncode,
                        "wall_s": time.perf_counter() - t0,
                        "stdout": out.stdout.strip().splitlines()[-4:]}))
        if out.returncode != 0:
            fail(f"the training launcher exited {out.returncode}:\n{out.stderr[-3000:]}")
        return out.stdout

    root = os.path.join(HERE, "build", "train_launcher")
    rwkv_root = os.path.join(HERE, "build", "train_launcher_rwkv6")
    for r in (root, rwkv_root):
        _shutil.rmtree(r, ignore_errors=True)
    base = ["--ckpt", root, "--ckpt-every", "2", "--batch", str(size.batch), "--seq",
            str(size.seq)] + (["--full-width"] if size.full else [])
    outs = [run(steps, base + ["--steps", str(steps)])
            for steps in (size.launcher_steps, 2 * size.launcher_steps)]
    if "resumed" in outs[0] or f"resumed at step {size.launcher_steps}" not in outs[1]:
        fail("the training launcher's second start did not resume from the first's "
             "checkpoint")
    out = run("rwkv6-1.6b, 2 steps", ["--arch", "rwkv6-1.6b", "--steps", "2", "--batch",
                                      "4", "--seq", "64", "--ckpt", rwkv_root])
    if "done at step 2" not in out:
        fail("the training launcher did not finish rwkv6-1.6b's two steps")
    for r in (root, rwkv_root):
        _shutil.rmtree(r, ignore_errors=True)


def _train_run(phase, size, device, name=None, over=None, batch=None, steps=None):
    """``steps`` (else ``size.steps``) steps of ``_train_setup``'s model on
    its first batch, repeated: the loss finite and falling; the launches per
    step exactly 2 forward (remat runs each layer twice) and 1 backward of
    K6 per rwkv layer, of K7 per rec layer and of K5 per layer that attends
    (dense, moe and attn; counts set to 0 just before the steps and read
    just after); the median step, tokens/s, peak memory and the idle share
    over 3 profiled steps.  Returns (the logged row, launches of the steps,
    cfg, params, opt, the batch)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    cfg, params, opt, ocfg, batch_at = _train_setup(size, device, name=name, over=over,
                                                    batch=batch)
    step_fn = make_train_step(cfg, ocfg)
    data = batch_at(0)
    setup_s = time.perf_counter() - t0
    steps = steps or size.steps
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    cuda_lib.reset_launches()
    for _ in range(steps):
        sync(device)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, data)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    per_step = {k: v / steps for k, v in launches.items()}
    kinds = cfg.layer_types()
    n_attn = sum(kinds.count(kd) for kd in ("dense", "moe", "attn"))
    want = {"rwkv6_scan": 2 * kinds.count("rwkv"), "rwkv6_scan_bwd": kinds.count("rwkv"),
            "rglru_scan": 2 * kinds.count("rec"), "rglru_scan_bwd": kinds.count("rec"),
            "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    want = {k: v for k, v in want.items() if v}
    med = float(np.median(times[2:]))
    n_tok = data["tokens"].shape[0] * data["tokens"].shape[1]
    row = {"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
           "layer_types": {kd: kinds.count(kd) for kd in sorted(set(kinds))},
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "remat": cfg.remat, "params": sum(x.numel() for x in params.parameters()),
           "reduced": [c for c in _reduced_note(cfg, get_config(cfg.name))
                       if not c.startswith("remat ")],
           "batch": list(data["tokens"].shape), "setup_s": setup_s, "losses": losses,
           "step_ms": times, "median_step_ms": med, "tokens_per_s": n_tok / med * 1e3,
           "launches_per_step": per_step, "expected_launches_per_step": want}
    if device == "cuda":
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        # the steps' results are dropped at once: they hold the model
        wall, busy, events = _profiled(
            lambda: [step_fn(params, opt, data) for _ in range(3)])[1:]
        row.update(profiled_steps=3, wall_ms=wall, device_busy_ms=busy,
                   idle_share=1.0 - busy / wall, top_device_events=events[:10])
    log(json.dumps(row))
    if not np.isfinite(losses).all():
        fail(f"{cfg.name}: a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: the loss did not fall on the repeated batch: {losses}")
    if device == "cuda" and per_step != want:
        fail(f"{cfg.name}: launches per step {per_step}, expected {want}")
    return row, launches, cfg, params, opt, data


def recurrent_training(size, device):
    """Phase 11b: each ``RECURRENT_TRAIN`` model trains
    ``RECURRENT_TRAIN_STEPS`` steps through ``_train_run``, one model on the
    card at a time.  Returns {arch: launch counts of its steps}."""
    out = {}
    for name, over, batch in RECURRENT_TRAIN:
        _, out[name], *held = _train_run("11b: training", size, device, name=name, over=over,
                                      batch=batch if size.full else None,
                                      steps=RECURRENT_TRAIN_STEPS)
        del held
        _free()
    return out


def phase11(size, device):
    """Phase 11: train joinml-oracle (at full width on the card) on one
    repeated batch of ``size.batch`` x ``size.seq`` pair tokens through
    ``_train_run``; then 4 microbatches against 1, the resume check and the
    launcher; then phase 11b, the recurrent families.  Returns the launch
    counts of the joinml-oracle steps, {arch: launch counts} of 11b's and
    the joinml-oracle steps' logged row (its median step, for phase 13b)."""
    from repro_torch.train import OptimizerConfig, make_train_step

    row, launches, cfg, params, opt, batch = _train_run("11: training", size, device)

    # 4 microbatches against 1 at lr 0 (tests/test_substrates.py's tolerances)
    still = OptimizerConfig(peak_lr=0.0, warmup_steps=0, weight_decay=0.0)
    metrics = {n: make_train_step(cfg, still, n)(params, opt, batch)[2] for n in (1, 4)}
    mb = {n: {"loss": float(m_["loss"]), "grad_norm": float(m_["grad_norm"])}
          for n, m_ in metrics.items()}
    log(json.dumps({"check": "phase 11: 4 microbatches against 1", **{str(n): v for n, v
                                                                      in mb.items()}}))
    if (abs(mb[4]["loss"] - mb[1]["loss"]) > 2e-2 * abs(mb[1]["loss"])
            or abs(mb[4]["grad_norm"] - mb[1]["grad_norm"]) > 3e-2 * mb[1]["grad_norm"]):
        fail(f"microbatched training differs: {mb}")
    del params, opt, metrics
    _free()
    _subprocess_resume(device, size)
    _train_launcher(device, size)
    return launches, recurrent_training(size, device), row


# ---------------------------------------------------------------------------
# phase 12: the mesh (data-parallel training, sharded scoring, the elastic
# restore)
# ---------------------------------------------------------------------------

DP_MODES = ("none", "int8")  # 12a's gradient all-reduces
DP_STEPS = 2                 # steps in each mode, at each world size
DP_WORLDS = (1, 2)           # ranks on the one card: NCCL in process, gloo in two processes
DP_BOUND_S = 600.0           # 12a's wait on its two rank processes
# the trainer's rule at bf16 (tests/test_torch_train.py): 6e-2 of a leaf's
# largest |x|
BF16_RULE = 6e-2


def _dp_opt(mode):
    """Phase 11's optimizer at ``eps = 1``: Adam's first step is then a
    smooth function of each gradient (``lr * g / (|g| + 1)``), not ``lr *
    sign(g)``, so two steps on gradients that differ by rounding compare
    elementwise."""
    from repro_torch.train import OptimizerConfig

    return OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=2, decay_steps=1000, eps=1.0,
                           grad_compression=mode)


def _digests(tree: dict) -> dict:
    """SHA-256 of each tensor's bytes (bf16 as its bits), on the host."""
    import hashlib

    out = {}
    for k, t in tree.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[k] = hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
    return out


def _against_one_process(size, device, data, dp_params, dp_m):
    """The world's first none step against the one-process step of phase 11
    (``make_train_step``) from the same initial weights on the whole batch:
    each leaf's update within the bf16 rule of its largest |update| plus one
    ulp of the new parameter (both sides round it to the parameter's type),
    and each first moment (0.1 of the clipped gradient) within the bf16 rule
    of its largest |m|.  Returns the worst ratio of each to its tolerance."""
    from repro_torch.train import make_train_step

    cfg, p, o, _, _ = _train_setup(size, device)
    p0 = {k: t.detach().float().clone() for k, t in p.named_parameters()}
    p, o, _ = make_train_step(cfg, _dp_opt("none"))(p, o, data)
    worst_p = worst_m = 0.0
    for k, t in p.named_parameters():
        new = t.detach().float()
        want, got = new - p0[k], dp_params[k].float() - p0[k]
        exp = torch.frexp(torch.maximum(new.abs(), dp_params[k].float().abs()))[1]
        ulp = torch.ldexp(torch.ones_like(new), exp - (8 if t.dtype == torch.bfloat16 else 24))
        tol = BF16_RULE * float(want.abs().max()) + ulp
        worst_p = max(worst_p, float(((got - want).abs() / tol).max()))
        m_tol = BF16_RULE * float(o["m"][k].abs().max()) + 1e-30
        worst_m = max(worst_m, float((dp_m[k] - o["m"][k]).abs().max()) / m_tol)
    return worst_p, worst_m


def _dp_world(size, device, world, rank, ckpt_root=None):
    """One rank's part of 12a (``torch.distributed`` is initialised):
    ``DP_STEPS`` steps of ``make_manual_dp_train_step`` in each of
    ``DP_MODES`` on phase 11's model and batch (its ``batch_at(0)``, of
    which the rank takes its slice), with the launches, wire types and
    all-reduce milliseconds of each step; rank 0 also holds the first none
    step against the one-process step, and saves the trained state for 12c
    under ``ckpt_root``.  Returns the logged row."""
    from repro_torch.checkpoint.checkpoint import save
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.manual_dp import make_manual_dp_train_step

    import torch.distributed as dist

    cfg, params, opt, _, batch_at = _train_setup(size, device)
    data = batch_at(0)
    mesh = make_mesh((world,), ("data",), device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    row = {"world": world, "rank": rank, "backend": dist.get_backend(),
           "batch": list(np.shape(data["tokens"])), "rank_rows": len(data["tokens"]) // world,
           "model": cfg.name, "layers": cfg.num_layers, "steps": {}}
    first = None
    for mode in DP_MODES:
        step = make_manual_dp_train_step(cfg, mesh, _dp_opt(mode))
        rows = []
        for _ in range(DP_STEPS):
            cuda_lib.reset_launches()
            with _TimedCollectives(device) as timed:
                sync(device)
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, data)
                sync(device)
            rows.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                         "all_reduce_ms": timed.ms["all_reduce"], "loss": float(m["loss"]),
                         "wire": step.wire,
                         "launches": {k: v for k, v in cuda_lib.LAUNCHES.items() if v}})
            if first is None:
                first = ({k: t.detach().clone() for k, t in params.named_parameters()},
                         {k: t.clone() for k, t in opt["m"].items()})
        row["steps"][mode] = rows
    if device == "cuda":
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    if ckpt_root is not None:
        t0 = time.perf_counter()
        save(ckpt_root, int(opt["step"]), {"params": params.state_dict(), "opt": opt})
        row["save_s"] = time.perf_counter() - t0
        row["digests"] = _digests(dict(params.state_dict()) | {
            f"m/{k}": t for k, t in opt["m"].items()} | {f"v/{k}": t for k, t in opt["v"].items()})
    del params, opt
    _free()
    if rank == 0:
        row["vs_one_process"] = dict(zip(("update", "moment"),
                                         _against_one_process(size, device, data, *first)))
    return row


def dp_rank(rank, world, store, device, full, ckpt_root, backend="gloo"):
    """A rank process of a data-parallel world, on card ``rank`` modulo the
    cards present; prints its row as JSON.  12a's world of 2 shares one card
    over gloo with CUDA tensors (NCCL refuses two ranks on one device);
    ``scripts/dp_scaling.py`` puts one rank on each card over NCCL."""
    import datetime

    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        row = _dp_world(TRAIN_FULL if full else TRAIN_REHEARSAL, device, world, rank,
                        ckpt_root if rank == 0 else None)
    finally:
        dist.destroy_process_group()
    print(json.dumps(row), flush=True)


def _dp_processes(size, device, world, ckpt_root, backend="gloo"):
    """A data-parallel world of ``world`` ranks, one process each (12a's on
    the one card); returns their rows."""
    import uuid

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    store = os.path.join(HERE, "build", f"dp_store_{uuid.uuid4().hex}")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    for rank in range(world):
        code = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                "chip_smoke.dp_rank({rank}, {world}, {store!r}, {device!r}, {full!r}, "
                "{ckpt!r}, {backend!r})").format(here=HERE, rank=rank, world=world,
                                                 store=store, device=device, full=size.full,
                                                 ckpt=ckpt_root, backend=backend)
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=HERE, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    rows, errs = [], []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=DP_BOUND_S)
            if proc.returncode != 0:
                errs.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
            else:
                rows.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if os.path.exists(store):
            os.remove(store)
    if errs:
        fail(f"a rank of the world of {world} failed: " + "\n".join(errs))
    return rows


def _check_dp_row(row, device):
    """Every step's loss finite; int8's gradient sum int32 on the wire; on
    the card, exactly 24 + 12 K5 launches a step for joinml-oracle (each
    layer's forward twice under remat, its backward once)."""
    kinds = None
    for mode, steps in row["steps"].items():
        for i, st in enumerate(steps):
            if not np.isfinite(st["loss"]):
                fail(f"12a world {row['world']} rank {row['rank']}: {mode} step {i} loss "
                     f"{st['loss']}")
            grads = {k for k in st["wire"] if k.startswith("sum") and k != "sum float32"}
            want = {"int8": {"sum int32"}, "none": set()}[mode]
            if grads != want or (mode == "none" and st["wire"].get("sum float32", 0) < 2):
                fail(f"12a world {row['world']}: {mode} step reduced {st['wire']}")
            if device == "cuda":
                if kinds is None:
                    kinds = {"flash_attention": 2 * row["layers"],
                             "flash_attention_bwd": row["layers"]}
                if st["launches"] != kinds:
                    fail(f"12a world {row['world']} rank {row['rank']}: launches a step "
                         f"{st['launches']}, expected {kinds}")


def _restore_at_world_one(size, device, ckpt_root, digests):
    """12c: the checkpoint 12a's world of 2 saved, restored in this world of
    one onto ``param_shardings`` (TRAIN_RULES: every leaf replicated on a
    one-rank mesh) as DTensors on ``device``; every leaf's bytes equal those
    rank 0 held."""
    from repro_torch.checkpoint.checkpoint import latest_step, restore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import TRAIN_RULES, sharding_for
    from repro_torch.models.partition import param_shardings

    cfg, params, opt, _, _ = _train_setup(size, device, seed=SEED + 1)
    mesh = make_mesh((1,), ("data",), device=device)
    sh = param_shardings(params, mesh, TRAIN_RULES)
    shardings = {"params": sh, "opt": {"m": sh, "v": sh,
                                       "step": sharding_for((), (), mesh, TRAIN_RULES)}}
    step = latest_step(ckpt_root)
    t0 = time.perf_counter()
    tree, manifest = restore(ckpt_root, step, {"params": params.state_dict(), "opt": opt},
                             shardings=shardings)
    sync(device)
    restore_s = time.perf_counter() - t0
    got = _digests({k: t.full_tensor() for k, t in tree["params"].items()} | {
        f"m/{k}": t.full_tensor() for k, t in tree["opt"]["m"].items()} | {
        f"v/{k}": t.full_tensor() for k, t in tree["opt"]["v"].items()})
    differ = sorted(k for k in digests if got.get(k) != digests[k])
    kinds = {type(t).__name__ for t in tree["params"].values()}
    row = {"check": "12c: saved at world 2, restored at world 1", "step": manifest["step"],
           "leaves": len(got), "differing": differ[:8], "restore_s": restore_s,
           "leaf_types": sorted(kinds),
           "device": str(next(iter(tree["params"].values())).device)}
    log(json.dumps(row))
    if differ or set(got) != set(digests) or kinds != {"DTensor"}:
        fail(f"12c: the restored checkpoint differs from what rank 0 saved: {row}")
    return row


def sharded_scoring(size, device):
    """12b: phase 6's scorer (the full joinml-oracle, seed 0, batches of
    ``size.batch``) over every pair of phase 6's tables, unsharded and over
    ``make_host_mesh()`` (one card: the same shapes and kernels), bit for
    bit; then ``launch/serve.py --mode score --shard`` as a subprocess.
    Returns the launches of the sharded scoring."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import PairScorer

    cfg = model_config(ORACLE_NAME, size)
    params = init_params(cfg, seed=SEED, device=device)
    left, right = entity_tables(size)
    plain = make_scorer(cfg, params, left, right, size.batch, device)
    mesh = make_host_mesh(device=device)
    sharded = PairScorer(cfg, params, plain.tokenize_pair, plain.yes_id, plain.no_id,
                         max_len=48, batch_size=size.batch, mesh=mesh, device=device)
    pairs = _all_pairs(len(left), len(right))
    sync(device)
    t0 = time.perf_counter()
    want = plain.score(pairs)
    plain_s = time.perf_counter() - t0
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    got = sharded.score(pairs)
    sharded_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    row = {"path": "12b: sharded scoring", "mesh": dict(mesh.shape), "pairs": len(pairs),
           "batch_size": sharded.batch_size, "forward_batches": sharded.forward_batches,
           "equal": bool(np.array_equal(got, want)), "max_abs_diff": float(np.abs(got - want).max()),
           "plain_s": plain_s, "sharded_s": sharded_s, "sharded_pairs_per_s": len(pairs) / sharded_s,
           "launches": launches}
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          ORACLE_NAME, "--mode", "score", "--shard", "--device", device],
                         capture_output=True, text=True, cwd=HERE, env=env, timeout=600)
    row["launcher"] = {"rc": out.returncode, "wall_s": time.perf_counter() - t0,
                       "stdout": out.stdout.strip().splitlines()[-3:]}
    log(json.dumps(row))
    # on the CPU the threaded reductions do not repeat their bits run to run
    # (tests/test_torch_sharded_serve.py); the rehearsal holds P to CARD_CPU_ATOL
    if not (row["equal"] if device == "cuda" else row["max_abs_diff"] <= CARD_CPU_ATOL):
        fail(f"12b: the sharded scorer differs from the unsharded one: {row}")
    if out.returncode != 0 or "sharding score batches over mesh" not in out.stdout:
        fail(f"12b: launch/serve.py --shard exited {out.returncode}:\n{out.stderr[-3000:]}")
    _path_launches("12b sharded scoring", launches, device)
    del params, plain, sharded
    _free()
    return launches


def phase12(size, model_size, device):
    """Phase 12: (12a) ``make_manual_dp_train_step`` on phase 11's model and
    batch at world 2 (two gloo processes on the one card) and at world 1
    (NCCL on the card in this process; gloo on the CPU), ``DP_STEPS`` steps
    in each of ``DP_MODES``; (12c) the world of 2's checkpoint restored in
    the world of 1; (12b) the sharded scorer.  Launch counts are set to 0
    just before each step and read just after.  Returns {path: launches}."""
    import datetime
    import shutil as _shutil

    import torch.distributed as dist

    t0 = time.perf_counter()
    ckpt_root = os.path.join(HERE, "build", "dp_ckpt")
    _shutil.rmtree(ckpt_root, ignore_errors=True)
    rows = {2: _dp_processes(size, device, 2, ckpt_root)}
    store = os.path.join(HERE, "build", "dp_store_world1")
    if os.path.exists(store):
        os.remove(store)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        rows[1] = [_dp_world(size, device, 1, 0)]
        saved = next(r for r in rows[2] if r["rank"] == 0)
        restored = _restore_at_world_one(size, device, ckpt_root, saved["digests"])
    finally:
        dist.destroy_process_group()
        os.remove(store)
    _shutil.rmtree(ckpt_root, ignore_errors=True)
    for world, rs in rows.items():
        for r in rs:
            r.pop("digests", None)
            log(json.dumps({"path": "12a: data-parallel training", **r}))
            _check_dp_row(r, device)
    vs = rows[2][0]["vs_one_process"]
    if max(vs.values()) > 1.0:
        fail(f"12a: the world of 2's none step differs from the one-process step: {vs}")
    summary = {"phase": "12a summary", "step_ms": {
        f"world {w} {mode}": [st["step_ms"] for r in rs for st in r["steps"][mode]]
        for w, rs in rows.items() for mode in DP_MODES}, "all_reduce_ms": {
        f"world {w} {mode}": [st["all_reduce_ms"] for r in rs for st in r["steps"][mode]]
        for w, rs in rows.items() for mode in DP_MODES},
        "max_memory_allocated_bytes": {f"world {w} rank {r['rank']}":
                                       r.get("max_memory_allocated_bytes") for w, rs in
                                       rows.items() for r in rs},
        "vs_one_process": vs, "restore_s": restored["restore_s"],
        "phase12a_c_s": time.perf_counter() - t0}
    log(json.dumps(summary))
    launches = {f"DP training, world {w} rank {r['rank']}, a step (12a)":
                rs_last for w, rs in rows.items() for r in rs
                for rs_last in [r["steps"][DP_MODES[-1]][-1]["launches"]]}
    launches["sharded scoring (12b)"] = sharded_scoring(model_size, device)
    return launches


# ---------------------------------------------------------------------------
# phase 10: the serving plane
# ---------------------------------------------------------------------------

SERVED_QUERIES = 8     # 10a's concurrent BaS COUNT queries, seeds 0-7
REMOTE_QUERIES = 4     # 10b's RemoteOracle queries, seeds 0-3
SERVE_WAIT_MS = 8.0    # the service's window timer, as the launcher sets it
SERVE_BOUND_S = 600.0  # every wait of phase 10 on a query, a process or a line
ORACLE_NAME = "joinml-oracle"
# the Oracle COUNT (phase 6) and the served COUNTs (10a, seeds 0-7) as they
# came out before K5 took its lse output and the trainer came in: the
# serving path must give them bit for bit
ORACLE_COUNT_BEFORE = 2736.2408429335214
SERVED_BEFORE = [2736.2408429335214, 2853.556150432342, 3101.306436028349,
                 3093.171724007253, 3101.7223845472313, 3329.776234265801,
                 2705.055569080088, 2634.2711395474203]


def _count(spec, oracle, budget):
    from repro_torch.core import Agg, Query

    return Query(spec=spec, agg=Agg.COUNT, oracle=oracle, budget=budget)


def _equal_runs(name, got, want, got_calls, want_calls):
    """Served equals serial: the estimate, the CI and ``calls``, bit for
    bit."""
    if (got.estimate != want.estimate or got.ci.lo != want.ci.lo
            or got.ci.hi != want.ci.hi or got_calls != want_calls):
        fail(f"{name}: ({got.estimate!r}, [{got.ci.lo!r}, {got.ci.hi!r}], "
             f"{got_calls}) differs from the serial run ({want.estimate!r}, "
             f"[{want.ci.lo!r}, {want.ci.hi!r}], {want_calls})")


def _served(svc, oracles, seeds, spec, budget, device, lat=None):
    """One BaS COUNT per (oracle, seed), concurrently through ``svc``; each
    query detaches its oracle when it ends.  ``lat`` gets each query's wall
    seconds."""
    from repro_torch.core import run_bas
    from repro_torch.serve import serve_queries

    svc.attach(*oracles)

    def job(i):
        t0 = time.perf_counter()
        try:
            return run_bas(_count(spec, oracles[i], budget), seed=seeds[i],
                           device=device)
        finally:
            if lat is not None:
                lat[i] = time.perf_counter() - t0
            svc.detach(oracles[i])

    return serve_queries(svc, [lambda i=i: job(i) for i in range(len(seeds))],
                         timeout=SERVE_BOUND_S)


def serving_in_process(size, device):
    """Phase 10a: eight concurrent BaS COUNT queries (seeds 0-7) whose
    Oracle is phase 6's scorer (``ModelOracle(..., name="joinml-oracle")``)
    through one ``OracleService(workers=1, max_wait_ms=8)`` with a
    ``LabelStore``, each equal to its serial run bit for bit; the summed
    charge equals the store's unique misses.  Launch counts are set to 0
    just before the served run and read just after.  Then the store, saved
    under its root at close, serves two of the queries again through a
    restarted service with no backend row.  Returns what 10b needs."""
    import shutil as _shutil

    from repro_torch.core import JoinSpec, ModelOracle, run_bas
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import LabelStore, OracleService

    t0 = time.perf_counter()
    cfg, timed, thr, _, left, right, _, params = oracle_setup(size, device)
    scorer = timed.scorer
    spec = JoinSpec([trigram_embeddings(left, EMBED_D),
                     trigram_embeddings(right, EMBED_D)])
    log(f"phase 10a set-up: {time.perf_counter() - t0:.1f} s")

    def named():
        return ModelOracle(scorer, thr, name=ORACLE_NAME)

    seeds = list(range(SERVED_QUERIES))
    serial = []
    sync(device)
    t0 = time.perf_counter()
    for s in seeds:
        o = named()
        serial.append((run_bas(_count(spec, o, size.budget), seed=s, device=device),
                       o.calls))
    sync(device)
    serial_s = time.perf_counter() - t0

    root = os.path.join(HERE, "build", "serving_smoke", "labels")
    _shutil.rmtree(root, ignore_errors=True)
    store = LabelStore(root=root)
    oracles = [named() for _ in seeds]
    lat = [0.0] * len(seeds)
    rows0 = scorer.pairs_scored
    with OracleService(workers=1, max_wait_ms=SERVE_WAIT_MS, label_store=store) as svc:
        cuda_lib.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        results = _served(svc, oracles, seeds, spec, size.budget, device, lat)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        stats, snap = svc.stats(), svc.snapshot()
    backend_rows = scorer.pairs_scored - rows0
    for s, got, o, (want, calls) in zip(seeds, results, oracles, serial):
        _equal_runs(f"served COUNT seed {s}", got, want, o.calls, calls)
    charged = sum(o.charged for o in oracles)
    labels = sum(o.calls for o in oracles)
    log(json.dumps({
        "path": "phase 10a: served COUNT", "model": cfg.name, "layers": cfg.num_layers,
        "queries": len(seeds), "budget": size.budget, "threshold": thr,
        "estimates": [r.estimate for r in results], "calls": [o.calls for o in oracles],
        "charged": charged, "store_misses": stats["store_misses"],
        "store_hits": sum(o.store_hits for o in oracles),
        "store": {k: stats[k] for k in ("store_hits", "store_shared", "store_misses",
                                        "store_entries", "store_hit_rate")},
        "windows": stats["windows"], "segments": stats["segments"],
        "segments_per_window": stats["segments_per_window"],
        "window_fill_ratio": stats["window_fill_ratio"],
        "window_dedup_ratio": stats["window_dedup_ratio"],
        "backend_calls": stats["backend_calls"], "backend_rows": backend_rows,
        "wall_s": wall, "serial_wall_s": serial_s, "labels": labels,
        "labels_per_s": labels / wall,
        "query_latency_s": {"p50": float(np.quantile(lat, 0.5)),
                            "p99": float(np.quantile(lat, 0.99))},
        "flush_rate_rows_per_s": snap.get("service.rate_rows_per_s"),
        "launches": launches}))
    if size.full and device == "cuda" and [r.estimate for r in results] != SERVED_BEFORE:
        fail(f"the served COUNTs moved: {[r.estimate for r in results]} where they "
             f"were {SERVED_BEFORE}")
    if charged != stats["store_misses"] or backend_rows != charged:
        fail(f"charge-once: {charged} charged, {stats['store_misses']} store misses, "
             f"{backend_rows} rows scored")
    if stats["windows"] >= stats["segments"]:
        fail("the served queries' flushes never shared a window")
    if device == "cuda" and launches.get("flash_attention", 0) <= 0:
        fail("flash_attention was not launched on the served path")

    # restart: the store saved at close serves two queries with no backend row
    rows0 = scorer.pairs_scored
    again = [named() for _ in range(2)]
    revived = LabelStore(root=root)
    with OracleService(workers=1, max_wait_ms=SERVE_WAIT_MS, label_store=revived) as svc:
        res2 = _served(svc, again, seeds[:2], spec, size.budget, device)
        stats2 = svc.stats()
    for s, got, o, (want, calls) in zip(seeds, res2, again, serial):
        _equal_runs(f"restarted COUNT seed {s}", got, want, o.calls, calls)
    log(json.dumps({"check": "phase 10a: restart from the saved store",
                    "segments_loaded": revived.loads,
                    "backend_rows": scorer.pairs_scored - rows0,
                    "rows_labelled": stats2["rows_labelled"],
                    "charged": [o.charged for o in again],
                    "store_hits": [o.store_hits for o in again]}))
    if (revived.loads != 1 or scorer.pairs_scored != rows0 or stats2["rows_labelled"]
            or any(o.charged or o.store_hits != o.calls for o in again)):
        fail("the restarted service did not serve the queries from the saved store")
    return dict(cfg=cfg, scorer=scorer, params=params, thr=thr, spec=spec, left=left,
                right=right, serial=serial, launches=launches)


def _launcher(argv, device):
    """``repro_torch.launch.serve`` as a subprocess (``--arch
    joinml-oracle``); its output on a pipe."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "joinml-oracle",
         "--device", device, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=HERE, env=env)


def _read_address(name, proc, seen):
    """Read ``proc``'s output until its ``listening on host:port`` line,
    within ``SERVE_BOUND_S``; every line read is kept in ``seen``."""
    import re
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    end = time.monotonic() + SERVE_BOUND_S
    try:
        while sel.select(timeout=max(end - time.monotonic(), 0.0)):
            line = proc.stdout.readline()
            if not line:
                break
            seen.append(line)
            m = re.search(r"listening on ([0-9.]+):(\d+)", line)
            if m:
                return (m.group(1), int(m.group(2)))
    finally:
        sel.close()
    fail(f"{name} printed no bound address:\n{''.join(seen)[-3000:]}")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port):
    """One GET of the OpenMetrics endpoint: its samples by name."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        ctype = resp.getheader("Content-Type")
    finally:
        conn.close()
    if resp.status != 200 or not ctype.startswith("application/openmetrics-text") \
            or not body.rstrip().endswith("# EOF"):
        fail(f"the metrics scrape returned {resp.status} {ctype}")
    return {ln.split(" ")[0]: float(ln.split(" ")[1]) for ln in body.splitlines()
            if ln and not ln.startswith("#")}


def _stop(name, proc, seen, terminate=True):
    """Stop a launcher subprocess and collect its output: a serving role is
    sent SIGTERM (it prints its shutdown lines and exits 0); otherwise
    (``terminate`` false) the process is waited for, within the bound."""
    if terminate and proc.poll() is None:
        proc.terminate()
    try:
        out = proc.communicate(timeout=SERVE_BOUND_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
        fail(f"{name} did not stop:\n{(''.join(seen) + out)[-3000:]}")
    return "".join(seen) + out


def serving_fleet(size, device, served):
    """Phase 10b: the launcher's fleet modes as subprocesses on 127.0.0.1,
    each serving phase 10a's Oracle (the same model, seed, tables,
    threshold and batch).  ``--mode worker --port 0`` and ``--mode server
    --port 0 --worker-hosts <worker>`` print their bound addresses; four
    ``RemoteOracle`` queries here equal 10a's serial runs bit for bit and
    the front reports remote shards; ``--mode client`` runs to its end;
    one scrape of ``--metrics-port``; the server is killed between two
    flushes of one query and restarted on its port, and the query ends
    with no label charged twice; ``--mode service`` exits 0."""
    import shutil as _shutil

    from repro_torch.core import ModelOracle, OracleBatch, run_bas
    from repro_torch.serve import RemoteOracle, serve_queries

    work = os.path.join(HERE, "build", "serving_smoke")
    os.makedirs(work, exist_ok=True)
    records = os.path.join(work, "records.json")
    with open(records, "w") as f:
        json.dump({"left": served["left"], "right": served["right"]}, f)
    serve_args = ["--records", records, "--threshold", repr(served["thr"]),
                  "--score-batch", str(size.batch), "--group", ORACLE_NAME]
    if size.full:
        serve_args.append("--full-width")
    metrics_port = _free_port()
    t0 = time.perf_counter()
    lines = {"worker": [], "server": []}
    service = _launcher(["--mode", "service", "--queries", "4", "--budget", "300",
                         "--label-store-mb", "64", "--tracker", "memory"], device)
    worker = _launcher(["--mode", "worker", "--port", "0", *serve_args], device)
    server = client = None
    try:
        w_addr = _read_address("the worker", worker, lines["worker"])
        server_args = ["--mode", "server", "--worker-hosts", f"{w_addr[0]}:{w_addr[1]}",
                       "--label-store-mb", "256", *serve_args]
        server = _launcher([*server_args, "--port", "0", "--metrics-port",
                            str(metrics_port)], device)
        s_addr = _read_address("the server", server, lines["server"])
        startup_s = time.perf_counter() - t0
        client = _launcher(
            ["--mode", "client", "--connect", f"{s_addr[0]}:{s_addr[1]}",
             "--group", ORACLE_NAME, "--queries", "4", "--budget", "300",
             "--n-side", str(min(48, len(served["left"]), len(served["right"])))],
            device)

        # four remote queries against the front, as 10a's serial runs
        oracles = [RemoteOracle(s_addr, ORACLE_NAME, timeout_s=SERVE_BOUND_S)
                   for _ in range(REMOTE_QUERIES)]
        seeds = list(range(REMOTE_QUERIES))

        def job(i):
            try:
                return run_bas(_count(served["spec"], oracles[i], size.budget),
                               seed=seeds[i], device=device)
            finally:
                oracles[i].close()

        t1 = time.perf_counter()
        remote = serve_queries(None, [lambda i=i: job(i) for i in seeds],
                               timeout=SERVE_BOUND_S)
        remote_s = time.perf_counter() - t1
        for s, got, o in zip(seeds, remote, oracles):
            want, calls = served["serial"][s]
            _equal_runs(f"remote COUNT seed {s}", got, want, o.calls, calls)
        metrics = _scrape(metrics_port)
        try:
            client_out = client.communicate(timeout=SERVE_BOUND_S)[0]
        except subprocess.TimeoutExpired:
            client.kill()
            fail("--mode client did not finish")
        if client.returncode != 0 or client_out.count("estimate=") != 4:
            fail(f"--mode client exited {client.returncode}:\n{client_out[-3000:]}")
        shards = metrics.get("repro_service_remote_shards", 0.0)
        windows = metrics.get("repro_service_windows", 0.0)
        log(json.dumps({
            "path": "phase 10b: the TCP fleet", "startup_s": startup_s,
            "worker": f"{w_addr[0]}:{w_addr[1]}", "server": f"{s_addr[0]}:{s_addr[1]}",
            "remote_queries": len(seeds), "remote_wall_s": remote_s,
            "estimates": [r.estimate for r in remote],
            "labels_per_s": sum(o.calls for o in oracles) / remote_s,
            "scrape": {k: v for k, v in metrics.items() if k in (
                "repro_service_windows", "repro_service_segments",
                "repro_service_remote_shards", "repro_service_remote_failures",
                "repro_service_rows_labelled", "repro_service_window_fill_ratio",
                "repro_label_store_hits", "repro_label_store_misses")},
            "client": [ln for ln in client_out.splitlines() if "[client]" in ln][:1]}))
        # the front shards a window of 2 x min_shard (256, the reference's
        # default) rows or more: the full run's windows are that large, the
        # rehearsal's small queries' windows need not be
        if windows <= 0 or (size.full and shards <= 0):
            fail(f"the front shows {shards} remote shards over {windows} windows")

        # the server killed between two flushes of one query, then restarted
        o = RemoteOracle(s_addr, ORACLE_NAME, timeout_s=SERVE_BOUND_S, retries=8,
                         max_backoff_s=1.0)
        local = ModelOracle(served["scorer"], served["thr"])
        n_right = len(served["right"])
        o.bind_sizes((len(served["left"]), n_right))
        o.set_budget(5)
        # matches and non-matches: flush 2 repeats one pair of flush 1
        probe = _all_pairs(8, n_right)
        probe_labels = ModelOracle(served["scorer"], served["thr"]).label(probe)
        pos, neg = probe[probe_labels == 1], probe[probe_labels == 0]
        first, second = np.stack([pos[0], neg[0]]), np.stack([neg[0], pos[1], neg[1]])
        batch = OracleBatch(o)
        h1 = batch.submit(first)
        batch.flush_async().result(timeout=SERVE_BOUND_S)
        server.kill()
        lines["server"].append(server.communicate(timeout=SERVE_BOUND_S)[0])
        t1 = time.perf_counter()
        server = _launcher([*server_args, "--port", str(s_addr[1])], device)
        lines["restarted"] = []
        if _read_address("the restarted server", server, lines["restarted"]) != s_addr:
            fail("the server did not come back on its port")
        restart_s = time.perf_counter() - t1
        h2 = batch.submit(second)
        batch.flush_async().result(timeout=SERVE_BOUND_S)
        o.close()
        want1, want2 = local.label(first), local.label(second)
        log(json.dumps({"check": "phase 10b: server killed between two flushes",
                        "restart_s": restart_s, "reconnects": o.conn.reconnects,
                        "calls": o.calls, "requests": o.requests,
                        "labels": [h1.labels.tolist(), h2.labels.tolist()]}))
        if (not np.array_equal(h1.labels, want1) or not np.array_equal(h2.labels, want2)
                or o.conn.reconnects < 1 or (o.calls, o.requests) != (4, 5)
                or o.remaining != 1):
            fail("the query across the server's restart was charged twice or "
                 "labelled otherwise than in process")
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.communicate()
        outs = {}
        for name, proc in (("server", server), ("worker", worker)):
            if proc is not None:
                outs[name] = _stop(name, proc, lines.get("restarted" if name == "server"
                                                         else name, []))
        outs["service"] = _stop("--mode service", service, [], terminate=False)
    for name, out in outs.items():
        proc = {"server": server, "worker": worker, "service": service}[name]
        if proc.returncode != 0:
            fail(f"--mode {name} exited {proc.returncode}:\n{out[-3000:]}")
    log(json.dumps({"launcher": {name: [ln for ln in out.splitlines()
                                        if "shut down" in ln or "windows:" in ln
                                        or "concurrent queries" in ln]
                                 for name, out in outs.items()}}))
    if "concurrent queries" not in outs["service"]:
        fail("--mode service did not run its queries")
    _shutil.rmtree(work, ignore_errors=True)


def _warm_count(rows_4c):
    return next(r["result"] for r in rows_4c if r["name"] == "COUNT warm index")


def serving_index(size, device, catalogs, warm_count):
    """Phase 10c: four concurrent ``run_auto`` COUNT queries on phase 4's
    tables through one ``OracleService(index_store=IndexStore(...))``:
    one K1 fp32 build sweep among them, three index hits, and every
    estimate equal to phase 4c's warm COUNT bit for bit.  Launch counts
    are set to 0 just before the queries and read just after."""
    from repro_torch.core import IndexStore, run_auto
    from repro_torch.core.oracle import ArrayOracle
    from repro_torch.core.types import BASConfig
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import OracleService, serve_queries

    ds, _ = catalogs
    cfg = BASConfig(max_dense_weight_bytes=size.dense_cap)
    oracles = [ArrayOracle(ds.truth) for _ in range(4)]
    with OracleService(workers=1, max_wait_ms=SERVE_WAIT_MS,
                       index_store=IndexStore(device=device)) as svc:
        svc.attach(*oracles)

        def job(i):
            try:
                return run_auto(_count(ds.spec(), oracles[i], size.budget), cfg,
                                seed=SEED, index_store=svc.index_store, device=device)
            finally:
                svc.detach(oracles[i])

        cuda_lib.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        results = serve_queries(svc, [lambda i=i: job(i) for i in range(4)],
                                timeout=SERVE_BOUND_S)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        stats = svc.stats()
    paths = [r.telemetry.dispatch.path for r in results]
    hits = [bool(r.telemetry.index and r.telemetry.index.hit) for r in results]
    log(json.dumps({"path": "phase 10c: index-served COUNTs", "queries": 4,
                    "wall_s": wall, "paths": paths, "index_hit": hits,
                    "estimates": [r.estimate for r in results],
                    "stats": {k: stats[k] for k in ("index_hit", "index_build",
                                                    "index_miss", "windows", "segments")},
                    "launches": launches}))
    for i, (r, o) in enumerate(zip(results, oracles)):
        _equal_runs(f"index-served COUNT {i}", r, warm_count, r.oracle_calls,
                    warm_count.oracle_calls)
        _check_budget(f"index-served COUNT {i}", r, size.budget)
    if stats["index_hit"] != 3 or stats["index_build"] != 1 or sorted(hits) != [
            False, True, True, True]:
        fail(f"the four queries did not share one build: {stats}, hits {hits}")
    # dispatch picks the path before the shared build lands, as the
    # reference's does: all four report "streaming", three with index.hit
    if paths != ["streaming"] * 4:
        fail(f"phase 10c dispatched {paths}, not four 'streaming' queries")
    if device == "cuda" and launches.get("sim_sweep[fp32]", 0) != 1:
        fail(f"phase 10c launched {launches}, not one fp32 build sweep")
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: the dry run and the roofline (repro_torch.launch.dryrun,
# repro_torch.roofline), the examples
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DryRunSize:
    cells: tuple      # the dry run's arguments: which cells, which meshes
    ok: int           # records it must write, by status
    skipped: int
    budget_s: float   # 13a's time budget (logged against its seconds)


DRYRUN_FULL = DryRunSize(("--all", "--both-meshes"), ok=64, skipped=16, budget_s=150.0)
DRYRUN_REHEARSAL = DryRunSize(("--arch", "llama3.2-1b", "--shape", "decode_32k",
                               "--both-meshes"), ok=2, skipped=0, budget_s=150.0)
EXAMPLES = ("plagiarism_analysis_torch", "traffic_video_join_torch",
            "multiway_join_optimizer_torch", "serve_oracle_torch")


def _src_env():
    return dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))


class _Started:
    """A subprocess started now, its output in temporary files (no pipe to
    fill while other work runs) and its end time taken by a watcher thread;
    :meth:`wait` returns (exit code, stdout, stderr, its seconds)."""

    def __init__(self, argv):
        import tempfile
        import threading

        self.out, self.err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, stdout=self.out, stderr=self.err, text=True,
                                     cwd=HERE, env=_src_env())
        self.t1 = None
        self.watch = threading.Thread(target=self._watch, daemon=True)
        self.watch.start()

    def _watch(self):
        self.proc.wait()
        self.t1 = time.perf_counter()

    def wait(self, timeout):
        self.watch.join(max(1.0, timeout - (time.perf_counter() - self.t0)))
        if self.watch.is_alive():
            self.proc.kill()
            self.watch.join()
        rc = self.proc.returncode
        seconds = self.t1 - self.t0
        texts = []
        for f in (self.out, self.err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        return rc, texts[0], texts[1], seconds


def start_dry_run(size):
    """Phase 13a: ``python -m repro_torch.launch.dryrun`` over ``size.cells``
    as a subprocess, a cell a worker process (one a core, two cores left to
    13b and 13c, which run beside it)."""
    import shutil

    out = os.path.join(HERE, "build", "dryrun_smoke")
    shutil.rmtree(out, ignore_errors=True)
    jobs = max(1, min(8, os.cpu_count() or 1) - 2)
    return _Started([sys.executable, "-m", "repro_torch.launch.dryrun", *size.cells,
                     "--out", out, "--jobs", str(jobs)]), out, jobs


def check_dry_run(size, started):
    """Phase 13a's records read back: the counts by status, each ok record's
    FLOPs, bytes, bound and ``fits``, every train record's all-reduce; then
    the 16 x 16 roofline table and the cells that do not fit.  Returns the
    records."""
    from repro_torch.roofline import report

    handle, out, jobs = started
    rc, stdout, stderr, seconds = handle.wait(900)
    if rc != 0:
        fail(f"the dry run exited {rc}:\n{stdout[-2000:]}\n{stderr[-3000:]}")
    recs = report.load_records(out)
    status = collections.Counter(r["status"] for r in recs)
    want = {"ok": size.ok, "skipped": size.skipped}
    if dict(status) != {k: v for k, v in want.items() if v}:
        fail(f"the dry run wrote {dict(status)} records, expected {want} and no error")
    for r in recs:
        if r["status"] != "ok":
            continue
        if not (r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["roofline"]["bound_s"] > 0
                and isinstance(r.get("fits"), bool)):
            fail(f"dry-run record {r['arch']} {r['shape']} {r['mesh']} lacks its counts")
        if r["shape"] == "train_4k" and not (
                r["num_microbatches"] == 8 and all(
                    sum(r["collective_by_op"].get(op, {}).values()) > 0
                    for op in ("_allgather_base_", "_reduce_scatter_base_", "allreduce_"))):
            fail(f"dry-run train record {r['arch']} {r['mesh']} lacks its 8 microbatches "
                 f"or a collective: {r['num_microbatches']}, {r['collective_by_op']}")
    ok = [r for r in recs if r["status"] == "ok"]
    if not all(r["fits"] for r in ok):
        fail("dry-run cells do not fit a rank: " + ", ".join(
            f"{r['arch']} {r['shape']} {r['mesh']} ({r['memory']['hbm_fraction']})"
            for r in ok if not r["fits"]))
    log(report.roofline_table(recs, "16x16"))
    log(json.dumps({"phase": "13a: dry run", "seconds": seconds, "jobs": jobs,
                    "budget_s": size.budget_s, "within_budget": seconds <= size.budget_s,
                    "records": dict(status), "fit": sum(r["fits"] for r in ok),
                    "train_collectives_by_op": {
                        f"{r['arch']} {r['mesh']}": r["collective_by_op"] for r in ok
                        if r["shape"] == "train_4k"},
                    "hbm_fraction": {f"{r['arch']} {r['shape']} {r['mesh']}":
                                     r["memory"]["hbm_fraction"] for r in ok},
                    "do_not_fit": sorted(
                        [r["arch"], r["shape"], r["mesh"], r["memory"]["hbm_fraction"],
                         r["param_bytes_sharded"]] for r in ok if not r["fits"]),
                    "slowest_trace_s": max(r["compile_s"] for r in ok)}))
    return recs


def roofline_cell(full: bool, batch: int, seq: int):
    """Phase 13b's trace, run in a process of its own (a fake world of one
    rank cannot share a process with another world): phase 11's step as a
    1 x 1-mesh cell (joinml-oracle, remat, the data-parallel step with the
    default AdamW) at ``batch`` x ``seq`` on meta tensors; prints one JSON
    line of its roofline and charged launches.  One microbatch, as phase 11
    steps (the sharded step on a 1 x 1 mesh)."""
    import repro_torch.launch.cells as C
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import ByteTokenizer
    from repro_torch.launch.dryrun import _roofline, fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import hw

    C.SHAPES = {"train_4k": dict(kind="train", seq=seq, batch=batch)}
    C.get_config = (lambda n: dataclasses.replace(get_config(n), remat=True)) if full else (
        lambda n: get_smoke_config(n, vocab_size=ByteTokenizer().vocab_size, remat=True))
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="meta")
        cell = C.build_cell(ORACLE_NAME, "train_4k", mesh, num_microbatches=1)
        cost, memory = C.trace_cell(cell, mesh)
        roof = _roofline(cost.flops, cost.bytes, cell.trace.links, hw.PEAK_FLOPS_BF16)
    print(json.dumps({"flops": cost.flops, "bytes": cost.bytes,
                      "collective_bytes": cost.collective_bytes, "roofline": roof,
                      "memory": memory, "kernels": cell.trace.kernels}), flush=True)


def start_roofline_cell(size):
    """Phase 13b: ``roofline_cell`` in a subprocess."""
    code = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            "chip_smoke.roofline_cell({full!r}, {batch!r}, {seq!r})").format(
                here=HERE, full=size.full, batch=size.batch, seq=size.seq)
    return _Started([sys.executable, "-c", code])


def check_roofline_cell(started, device, train_row):
    """Phase 13b's result: its charged launches must equal phase 11's a
    step, and phase 11's median step must not be shorter than the cell's
    ``bound_s`` (else a count is wrong).  Logs the step's share of its
    roofline."""
    rc, stdout, stderr, seconds = started.wait(600)
    if rc != 0:
        fail(f"phase 13b's trace exited {rc}:\n{stderr[-3000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    charged = {k: v["launches"] for k, v in res["kernels"].items()}
    # on the CPU no kernel launches: the launches phase 11 holds the card to
    card = train_row["launches_per_step" if device == "cuda" else "expected_launches_per_step"]
    bound_ms = res["roofline"]["bound_s"] * 1e3
    med = train_row["median_step_ms"]
    log(json.dumps({"phase": "13b: the roofline of phase 11's step", "trace_s": seconds,
                    **res, "charged_launches": charged,
                    "phase11_launches_per_step": card, "phase11_median_step_ms": med,
                    "bound_ms": bound_ms, "share_of_roofline": bound_ms / med}))
    if charged != card:
        fail(f"phase 13b charged {charged} launches a step, phase 11 counted {card}")
    if med < bound_ms:
        fail(f"phase 11's median step {med:.3f} ms is shorter than its roofline bound "
             f"{bound_ms:.3f} ms: a count is wrong")


def start_examples(device):
    """Phase 13c: the four ``examples/*_torch.py`` copies of the reference's
    examples, all at once as subprocesses (on the card without
    ``--device``)."""
    argv = [] if device == "cuda" else ["--device", device]
    return {name: _Started([sys.executable, os.path.join("examples", f"{name}.py"), *argv])
            for name in EXAMPLES}


def check_examples(started):
    """Each example exited 0 and printed its result; their output is
    logged."""
    for name, handle in started.items():
        rc, stdout, stderr, seconds = handle.wait(600)
        if rc != 0 or not stdout.strip():
            fail(f"example {name} exited {rc}:\n{stderr[-3000:]}")
        log(json.dumps({"phase": "13c: example", "example": name, "seconds": seconds}))
        for line in stdout.strip().splitlines():
            log(f"  [{name}] {line}")


def phase13(size, train_size, device, train_row):
    """Phase 13: 13a, 13b and 13c run at once (each in subprocesses: the
    dry run and the trace on the host's cores, the examples on the card),
    then each is checked."""
    dry = start_dry_run(size)
    cell = start_roofline_cell(train_size)
    runs = start_examples(device)
    check_dry_run(size, dry)
    check_roofline_cell(cell, device, train_row)
    check_examples(runs)


# ---------------------------------------------------------------------------
# phase 14: the sharded train step (FSDP over "data", tensor parallelism
# over "model", 8 microbatches)
# ---------------------------------------------------------------------------

SHARDED_MICRO = 8      # the reference's DEFAULT_MICROBATCHES
SHARDED_STEPS = 2      # phase 14's steps on each mesh
SHARDED_BOUND_S = 600.0
# phase 14's jobs: phase 11's joinml-oracle and batch (16 rows, also in the
# rehearsal: 8 microbatches over 2 batch shards) at f32 (the one-process step is
# held to the trainer's f32 rule) on each (data, model) mesh of worlds 1 and 2
SHARDED_ORACLE = {"name": ORACLE_NAME, "over": {"dtype": "float32"}, "batch": 16,
                  "steps": SHARDED_STEPS, "opt": "rule", "compare": "one_process"}
SHARDED_JOBS = [dict(SHARDED_ORACLE, mesh=m) for m in ((1, 1), (2, 1), (1, 2))]


def _sharded_opt(kind):
    """``"rule"``: lr 1e-2, no warmup, eps 1, no clipping (Adam's first step
    ``lr * g / (|g| + 1)``, far above a parameter's ulp, so an update
    compares elementwise); ``"phase11"``: phase 11's AdamW."""
    from repro_torch.train import OptimizerConfig

    if kind == "rule":
        return OptimizerConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=10, eps=1.0,
                               clip_norm=1e6)
    return OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=2, decay_steps=1000)


class _TimedCollectives:
    """The collectives the trainers of phases 12 and 14 call (``all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and their
    ``*_single`` names) wrapped: the device synchronised before and after
    each outermost call, the calls' milliseconds summed by kind."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_gather_single", "reduce_scatter_single")

    def __init__(self, device):
        import torch.distributed as dist

        self.dist, self.device = dist, device
        self.inner = {n: getattr(dist, n) for n in self.NAMES if hasattr(dist, n)}
        self.ms = collections.Counter()
        self.depth = 0

    def _wrap(self, name, fn):
        kind = "all_reduce" if name == "all_reduce" else \
            "reduce_scatter" if "scatter" in name else "all_gather"

        def timed(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            try:
                sync(self.device)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync(self.device)
                self.ms[kind] += (time.perf_counter() - t0) * 1e3
                return out
            finally:
                self.depth -= 1
        return timed

    def __enter__(self):
        for n, fn in self.inner.items():
            setattr(self.dist, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.inner.items():
            setattr(self.dist, n, fn)


def _expected_launches(cfg, micro):
    """K5, K6 and K7 launches a rank's step makes: each layer's forward
    twice under remat and its backward once, a microbatch."""
    kinds = cfg.layer_types()
    n_attn = sum(kinds.count(kd) for kd in ("dense", "moe", "attn"))
    want = {"rwkv6_scan": 2 * kinds.count("rwkv"), "rwkv6_scan_bwd": kinds.count("rwkv"),
            "rglru_scan": 2 * kinds.count("rec"), "rglru_scan_bwd": kinds.count("rec"),
            "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    return {k: micro * v for k, v in want.items() if v}


def _block_loss(cfg, params, data, micro, shards):
    """``loss_fn`` of the whole model on this card, forward only, over the
    blocks the sharded step computes (each microbatch's rows split over the
    batch shards; their MoE groups), averaged: the sharded step's first
    loss without a collective."""
    from repro_torch.models import loss_fn

    rows = len(data["tokens"]) // (micro * shards)
    losses = []
    with torch.no_grad():
        for i in range(micro * shards):
            block = {k: v[i * rows:(i + 1) * rows] for k, v in data.items()}
            losses.append(float(loss_fn(cfg, params, block)))
    return float(np.mean(losses))


def _sharded_job(size, device, job, out_dir):
    """One job of a rank of phase 14 (``torch.distributed`` is initialised
    with a world of the mesh's size): its model from the seed, whole on
    every rank, then laid out by ``shard_params`` under TRAIN_RULES with
    sharded AdamW moments; ``job["steps"]`` steps of ``make_train_step(...,
    SHARDED_MICRO)`` under ``sharding_context`` on phase 11's first batch,
    each with its ms, its collectives' ms, loss, grad norm and launches.
    Rank 0 also writes the first step's parameters (gathered whole) for
    the one-process comparison, or holds the first loss against
    ``_block_loss``.  Returns the logged row."""
    import torch.distributed as dist

    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import TRAIN_RULES, sharding_context
    from repro_torch.models.partition import shard_params
    from repro_torch.train import init_opt_state, make_train_step
    from repro_torch.train.sharded import whole

    rank = dist.get_rank()
    cfg, params, _, _, batch_at = _train_setup(size, device, name=job["name"],
                                               over=job["over"], batch=job["batch"],
                                               with_opt=False)
    data = batch_at(0)
    shape = tuple(job["mesh"])
    tag = f"{cfg.name} {shape[0]}x{shape[1]}"
    row = {"phase": "14: sharded training", "job": tag, "rank": rank,
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "mesh": {"data": shape[0], "model": shape[1]}, "model": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "micro": SHARDED_MICRO,
           "batch": list(np.shape(data["tokens"])),
           "params": sum(p.numel() for p in params.parameters())}
    if job["compare"] == "forward_loss" and rank == 0:
        t0 = time.perf_counter()
        row["one_card_loss"] = _block_loss(cfg, params, data, SHARDED_MICRO, shape[0])
        row["one_card_loss_s"] = time.perf_counter() - t0
    mesh = make_mesh(shape, ("data", "model"), device=device)
    shard_params(params, mesh, TRAIN_RULES)
    _free()
    opt = init_opt_state(params)
    row["held_bytes"] = sum(p._local_tensor.numel() * p.element_size()
                            for p in params.parameters())
    step = make_train_step(cfg, _sharded_opt(job["opt"]), SHARDED_MICRO)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    row["steps"] = []
    for i in range(job["steps"]):
        cuda_lib.reset_launches()
        with _TimedCollectives(device) as timed:
            sync(device)
            t0 = time.perf_counter()
            with sharding_context(mesh, TRAIN_RULES):
                params, opt, m = step(params, opt, data)
            sync(device)
        row["steps"].append({"step_ms": (time.perf_counter() - t0) * 1e3,
                             "collective_ms": dict(timed.ms), "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "launches": {k: v for k, v in cuda_lib.LAUNCHES.items() if v}})
        if i == 0 and job["compare"] == "one_process":
            first = {k: whole(p).cpu() for k, p in params.named_parameters()}
            if rank == 0:
                path = os.path.join(out_dir, f"phase14_{shape[0]}x{shape[1]}.pt")
                torch.save({"params": first, **row["steps"][0]}, path)
                row["first_step"] = path
            del first
    if device == "cuda":
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        row["expected_launches"] = _expected_launches(cfg, SHARDED_MICRO)
    del params, opt
    _free()
    return row


def sharded_rank(rank, world, store, device, full, jobs, out_dir, backend="gloo"):
    """A rank process of a phase-14 or 15 world, on card ``rank`` modulo the
    cards present; runs every job whose mesh has ``world`` ranks (a train
    job by ``_sharded_job``, a serve job by ``_serving_job``); prints its
    rows as JSON.  Phase 14's world of 2 shares one card over gloo with CUDA
    tensors; ``scripts/sharded_step.py`` puts one rank on each card over
    NCCL."""
    import datetime

    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        size = TRAIN_FULL if full else TRAIN_REHEARSAL
        run = {"train": _sharded_job, "serve": _serving_job}
        rows = [run[job.get("kind", "train")](size, device, job, out_dir) for job in jobs
                if int(np.prod(job["mesh"])) == world]
    finally:
        dist.destroy_process_group()
    print(json.dumps(rows), flush=True)


def sharded_processes(size, device, world, jobs, out_dir, backend="gloo"):
    """A phase-14 world of ``world`` rank processes; returns their rows."""
    import uuid

    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(HERE, "build", f"sharded_store_{uuid.uuid4().hex}")
    # a rank that dies of a signal prints its threads' Python stacks
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), PYTHONFAULTHANDLER="1")
    procs = []
    for rank in range(world):
        code = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                "chip_smoke.sharded_rank({rank}, {world}, {store!r}, {device!r}, {full!r}, "
                "{jobs!r}, {out!r}, {backend!r})").format(
                    here=HERE, rank=rank, world=world, store=store, device=device,
                    full=size.full, jobs=jobs, out=out_dir, backend=backend)
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=HERE, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    rows, errs = [], []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=SHARDED_BOUND_S)
            if proc.returncode != 0:
                errs.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
            else:
                rows += json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if os.path.exists(store):
            os.remove(store)
    if errs:
        fail(f"a rank of the sharded world of {world} failed: " + "\n".join(errs))
    return rows


def one_process_first_step(size, device, job):
    """The one-process step (``make_train_step(..., SHARDED_MICRO)`` on the
    whole model and batch) from the jobs' initial weights: (parameters
    before, after, loss, grad norm), on the host."""
    from repro_torch.train import make_train_step

    cfg, params, opt, _, batch_at = _train_setup(size, device, name=job["name"],
                                                 over=job["over"], batch=job["batch"])
    before = {k: p.detach().cpu().clone() for k, p in params.named_parameters()}
    params, opt, m = make_train_step(cfg, _sharded_opt(job["opt"]), SHARDED_MICRO)(
        params, opt, batch_at(0))
    after = {k: p.detach().cpu().clone() for k, p in params.named_parameters()}
    del params, opt
    _free()
    return before, after, float(m["loss"]), float(m["grad_norm"])


def hold_first_step(one, path):
    """A sharded world's first step (saved at ``path``) against the
    one-process step, the trainer's f32 rule (``tests/test_torch_manual_dp.py``):
    the loss within 1e-5 relative, the grad norm within 1e-4, each
    element's update within 1e-4 of its leaf's largest |update| plus one
    ulp of the new parameter (both sides round it to its type).  Returns
    the worst ratio of each to its tolerance."""
    before, after, loss, gnorm = one
    got = torch.load(path)
    worst = 0.0
    for k, b in before.items():
        new, mine = after[k].float(), got["params"][k].float()
        want, du = new - b.float(), mine - b.float()
        exp = torch.frexp(torch.maximum(new.abs(), mine.abs()))[1]
        ulp = torch.ldexp(torch.ones_like(new), exp - 24)
        tol = 1e-4 * float(want.abs().max()) + ulp
        worst = max(worst, float(((du - want).abs() / tol).max()))
    return {"loss": abs(got["loss"] / loss - 1) / 1e-5,
            "grad_norm": abs(got["grad_norm"] / gnorm - 1) / 1e-4, "update": worst}


def check_sharded_rows(rows, device, ones=None):
    """Every step's loss finite and the same on every rank of a job; on the
    card the launches a step what ``_expected_launches`` says; each
    one-process job's first step held by ``hold_first_step`` against
    ``ones[rows of its batch]``; each
    forward-loss job's first loss within the trainer's bf16 rule (6e-2) of
    the one-card loss.  Returns {job: {the held ratios}}."""
    held = {}
    jobs = collections.defaultdict(list)
    for r in rows:
        jobs[r["job"]].append(r)
    for tag, rs in jobs.items():
        for r in rs:
            for i, st in enumerate(r["steps"]):
                if not np.isfinite(st["loss"]):
                    fail(f"14 {tag} rank {r['rank']}: step {i} loss {st['loss']}")
                if device == "cuda" and st["launches"] != r["expected_launches"]:
                    fail(f"14 {tag} rank {r['rank']}: launches a step {st['launches']}, "
                         f"expected {r['expected_launches']}")
        if len({json.dumps([st["loss"] for st in r["steps"]]) for r in rs}) != 1:
            fail(f"14 {tag}: the ranks report other losses")
        lead = next(r for r in rs if r["rank"] == 0)
        if "first_step" in lead:
            held[tag] = hold_first_step(ones[lead["batch"][0]], lead["first_step"])
            os.remove(lead["first_step"])
        if "one_card_loss" in lead:
            first, want = lead["steps"][0]["loss"], lead["one_card_loss"]
            held[tag] = {"loss": abs(first - want) / (BF16_RULE * abs(want))}
        if held.get(tag) and max(held[tag].values()) > 1.0:
            fail(f"14 {tag}: the first step differs: {held[tag]}")
    return held


def _in_world_of_one(device, run):
    """``run()`` in a process group of this process alone (NCCL on the
    card, gloo on the CPU), destroyed after."""
    import datetime

    import torch.distributed as dist

    store = os.path.join(HERE, "build", "world_of_one_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store, 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        return run()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):  # the store may have removed its file itself
            os.remove(store)


def phase14(size, device):
    """Phase 14: ``SHARDED_JOBS`` (phase 11's model at f32, 8 microbatches,
    ``SHARDED_STEPS`` steps) at world 1 over NCCL in this process on a 1 x
    1 mesh, and at world 2 as two processes on the one card over gloo with
    CUDA tensors on the 2 x 1 and 1 x 2 meshes; each world's first step
    held against the one-process step.  Launch counts are set to 0 just
    before each step and read just after.  Returns {path: launches}."""
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "phase14")
    one = one_process_first_step(size, device, SHARDED_ORACLE)
    rows = sharded_processes(size, device, 2, SHARDED_JOBS, out_dir)
    rows += _in_world_of_one(device, lambda: [
        _sharded_job(size, device, job, out_dir) for job in SHARDED_JOBS
        if int(np.prod(job["mesh"])) == 1])
    for r in rows:
        log(json.dumps(r))
    held = check_sharded_rows(rows, device, {SHARDED_ORACLE["batch"]: one})
    log(json.dumps({"phase": "14 summary", "held_ratios": held, "step_ms": {
        f"{r['job']} rank {r['rank']}": [st["step_ms"] for st in r["steps"]] for r in rows},
        "collective_ms": {f"{r['job']} rank {r['rank']}":
                          [st["collective_ms"] for st in r["steps"]] for r in rows},
        "max_memory_allocated_bytes": {f"{r['job']} rank {r['rank']}":
                                       r.get("max_memory_allocated_bytes") for r in rows},
        "phase14_s": time.perf_counter() - t0}))
    return {f"sharded training, {r['job']} rank {r['rank']}, a step (14)":
            r["steps"][-1]["launches"] for r in rows}


# ---------------------------------------------------------------------------
# phase 15: sharded prefill and decode (SERVE_RULES' 2-D weights, DECODE_RULES'
# cache slots over "model")
# ---------------------------------------------------------------------------

SERVE_RULE = 2e-5      # the port's f32 forward rule, of the largest |logit|
# phase 15's jobs: phase 14's joinml-oracle at f32, the prefill of its 16 x
# 128 batch, then 24 decode steps from position 0 into a cache of 32 slots
# (on 1 x 2 the steps cross slot 16, the slots' shard boundary); and
# whisper-medium at f32 (the rehearsal: reduced), 8 steps over a seeded
# cache of (4, 1,500) frames (padded to 1,536, 768 a model rank), on 1 x 2
SERVING_ORACLE = {"kind": "serve", "name": ORACLE_NAME, "over": {"dtype": "float32"},
                  "batch": 16, "prefill": True, "steps": 24, "slots": 32}
SERVING_WHISPER = {"kind": "serve", "name": "whisper-medium", "over": {"dtype": "float32"},
                   "batch": 4, "prefill": False, "steps": 8, "slots": 32}
SERVING_JOBS = [dict(SERVING_ORACLE, mesh=m) for m in ((1, 1), (2, 1), (1, 2))] + [
    dict(SERVING_WHISPER, mesh=(1, 2))]


def _serving_inputs(size, device, job):
    """A serve job's model (whole, from the seed), its prefill batch (phase
    11's first batch for the Oracle), the decode's tokens a step (B, 1)
    and its whole cache: zeros, but for whisper's encoder K/V, drawn from
    the seed over every frame."""
    from repro_torch.models import init_cache, init_params

    if job["name"] == ORACLE_NAME:
        cfg, params, _, _, batch_at = _train_setup(size, device, over=job["over"],
                                                   batch=job["batch"], with_opt=False)
        batch = {"tokens": torch.as_tensor(batch_at(0)["tokens"])}
    else:
        cfg = model_config(job["name"], size, **job["over"])
        params = init_params(cfg, SEED + 4, device=device)
        rng = np.random.default_rng(SEED + 12)
        batch = {"tokens": torch.from_numpy(
            rng.integers(8, cfg.vocab_size, (job["batch"], job["steps"])))}
    tokens = [batch["tokens"][:, i:i + 1].long() for i in range(job["steps"])]
    cache = init_cache(cfg, job["batch"], job["slots"], device)
    if "xk" in cache:
        gen = torch.Generator(device=device).manual_seed(SEED + 15)
        for key in ("xk", "xv"):
            cache[key].copy_(torch.randn(cache[key].shape, generator=gen, device=device,
                                         dtype=torch.float32))
    return cfg, params, batch, tokens, cache


def _serving_decode(cfg, params, cache, tokens, device, rows=slice(None), timed=None):
    """``len(tokens)`` decode steps from position 0, each timed; returns
    (logits a step (on the device), ms a step)."""
    from repro_torch.models import decode_step

    logits, ms = [], []
    for i, tok in enumerate(tokens):
        sync(device)
        t0 = time.perf_counter()
        lg, cache = decode_step(cfg, params, cache, tok[rows].to(device), i)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    return logits, ms


def one_process_serving(size, device, job):
    """The one-process prefill and decode of ``job`` on the card: {prefill
    logits, decode logits a step}, on the host."""
    from repro_torch.models import forward

    cfg, params, batch, tokens, cache = _serving_inputs(size, device, job)
    out = {}
    if job["prefill"]:
        out["prefill"] = forward(cfg, params, batch).cpu()
    logits, _ = _serving_decode(cfg, params, cache, tokens, device)
    out["steps"] = [lg.cpu() for lg in logits]
    del params, cache
    _free()
    return out


def _serving_job(size, device, job, out_dir):
    """One serve job of a rank of phase 15: the model from the seed, whole
    on every rank, laid out by ``shard_params`` under SERVE_RULES (whose
    parameter layout DECODE_RULES shares), the cache by ``shard_cache``
    under DECODE_RULES; the prefill of the rank's rows under SERVE_RULES
    (its ms, collectives, launches), then the decode steps under
    DECODE_RULES.  Rank 0 writes the logits, rows and vocabulary columns
    gathered, for the one-process comparison.  Returns the logged row."""
    import torch.distributed as dist

    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.cells import tree_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import DECODE_RULES, SERVE_RULES, sharding_context
    from repro_torch.models import forward
    from repro_torch.models.partition import shard_cache, shard_params
    from repro_torch.train.sharded import gather_dim, top

    rank = dist.get_rank()
    cfg, params, batch, tokens, cache = _serving_inputs(size, device, job)
    shape = tuple(job["mesh"])
    tag = f"{cfg.name} {shape[0]}x{shape[1]}"
    mesh = make_mesh(shape, ("data", "model"), device=device)
    shard_params(params, mesh, SERVE_RULES)
    cache = shard_cache(cache, mesh, DECODE_RULES)
    _free()
    at = mesh.coordinate()
    n = job["batch"] // shape[0]
    rows = slice(at["data"] * n, (at["data"] + 1) * n)
    with sharding_context(mesh, SERVE_RULES):
        split = top(params)[1].n > 1

    def whole(lg):
        if split:
            lg = gather_dim(lg, lg.ndim - 1, mesh.group(("model",)), shape[1])
        return gather_dim(lg, 0, mesh.group(("data",)), shape[0]).cpu()

    row = {"phase": "15: sharded serving", "job": tag, "rank": rank,
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "mesh": {"data": shape[0], "model": shape[1]}, "model": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": job["batch"],
           "held_param_bytes": tree_bytes(params), "held_cache_bytes": tree_bytes(cache)}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    saved = {}
    if job["prefill"]:
        cuda_lib.reset_launches()
        with _TimedCollectives(device) as timed:
            sync(device)
            t0 = time.perf_counter()
            with sharding_context(mesh, SERVE_RULES):
                logits = forward(cfg, params, {k: v[rows] for k, v in batch.items()})
            sync(device)
        row.update(prefill_ms=(time.perf_counter() - t0) * 1e3,
                   prefill_collective_ms=dict(timed.ms),
                   prefill_launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v},
                   prefill_finite=bool(torch.isfinite(logits).all()))
        saved["prefill"] = whole(logits)
    cuda_lib.reset_launches()
    with _TimedCollectives(device) as timed, sharding_context(mesh, DECODE_RULES):
        logits, ms = _serving_decode(cfg, params, cache, tokens, device, rows)
    row.update(decode_step_ms=ms, decode_collective_ms=dict(timed.ms),
               decode_launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v},
               decode_finite=bool(all(torch.isfinite(lg).all() for lg in logits)))
    saved["steps"] = [whole(lg) for lg in logits]
    if device == "cuda":
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        path = os.path.join(out_dir, f"phase15_{cfg.name}_{shape[0]}x{shape[1]}.pt")
        torch.save(saved, path)
        row["logits"] = path
    del params, cache
    _free()
    return row


def hold_serving(one, path, exact):
    """A world's gathered logits (saved at ``path``) against the one-process
    run's: bit for bit where ``exact`` (a 1 x 1 mesh), else each within
    ``SERVE_RULE`` of its largest |logit|.  Returns the worst ratio of an
    error to its tolerance (0 for equal bits)."""
    got = torch.load(path)
    pairs = list(zip(got["steps"], one["steps"]))
    if "prefill" in one:
        pairs.append((got["prefill"], one["prefill"]))
    worst = 0.0
    for mine, want in pairs:
        if mine.shape != want.shape:
            fail(f"15: logits of shape {tuple(mine.shape)}, expected {tuple(want.shape)}")
        if exact:
            worst = max(worst, 0.0 if torch.equal(mine, want) else float("inf"))
        else:
            tol = SERVE_RULE * float(want.abs().max())
            worst = max(worst, float((mine - want).abs().max()) / tol)
    return worst


def check_serving_rows(rows, device, ones):
    """Every rank's logits finite; on the card each prefill launches K5 once
    an attention layer a rank and the decode no kernel; each job's
    logits held by ``hold_serving`` against the one-process run.  Returns
    {job: the worst held ratio}."""
    held = {}
    for r in rows:
        if not r["decode_finite"] or not r.get("prefill_finite", True):
            fail(f"15 {r['job']} rank {r['rank']}: logits not finite")
        if device == "cuda":
            if "prefill_launches" in r and r["prefill_launches"] != {
                    "flash_attention": r["layers"]}:
                fail(f"15 {r['job']} rank {r['rank']}: prefill launched "
                     f"{r['prefill_launches']}, expected {r['layers']} K5")
            if r["decode_launches"]:
                fail(f"15 {r['job']} rank {r['rank']}: decode launched {r['decode_launches']}")
        if "logits" in r:
            exact = r["mesh"] == {"data": 1, "model": 1}
            held[r["job"]] = hold_serving(ones[r["model"]], r["logits"], exact)
            os.remove(r["logits"])
            if held[r["job"]] > 1.0:
                fail(f"15 {r['job']}: the logits differ from one process's "
                     f"({held[r['job']]} of the rule)")
    return held


def phase15(size, device):
    """Phase 15: ``SERVING_JOBS`` (joinml-oracle's prefill and 24 decode
    steps, whisper-medium's decode over split frames) at world 1 over NCCL
    in this process on a 1 x 1 mesh, and at world 2 as two processes on the
    one card over gloo with CUDA tensors on the 2 x 1 and 1 x 2 meshes; each
    world's logits held against the one-process run.  Launch counts are
    set to 0 just before each prefill and decode and read just after.
    Returns {path: launches}."""
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "phase15")
    os.makedirs(out_dir, exist_ok=True)
    ones = {job["name"]: one_process_serving(size, device, job)
            for job in (SERVING_ORACLE, SERVING_WHISPER)}
    rows = sharded_processes(size, device, 2, SERVING_JOBS, out_dir)
    rows += _in_world_of_one(device, lambda: [
        _serving_job(size, device, job, out_dir) for job in SERVING_JOBS
        if int(np.prod(job["mesh"])) == 1])
    for r in rows:
        log(json.dumps(r))
    held = check_serving_rows(rows, device, ones)
    log(json.dumps({"phase": "15 summary", "held_ratios": held, "prefill_ms": {
        f"{r['job']} rank {r['rank']}": r.get("prefill_ms") for r in rows},
        "decode_step_ms_median": {f"{r['job']} rank {r['rank']}":
                                  float(np.median(r["decode_step_ms"])) for r in rows},
        "collective_ms": {f"{r['job']} rank {r['rank']}":
                          [r.get("prefill_collective_ms"), r["decode_collective_ms"]]
                          for r in rows},
        "max_memory_allocated_bytes": {f"{r['job']} rank {r['rank']}":
                                       r.get("max_memory_allocated_bytes") for r in rows},
        "phase15_s": time.perf_counter() - t0}))
    return {f"sharded prefill, {r['job']} rank {r['rank']} (15)": r["prefill_launches"]
            for r in rows if "prefill_launches" in r}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 4, 4b, 4c, 6, 7, 8, 9, 10, 11, 12, 13, 14 and 15 at a "
                         "tiny size on the CPU (exits 3)")
    if ap.parse_args().rehearse_cpu:
        from repro_torch.kernels import cuda_lib

        results, hot, catalogs, chain = run_phase4(REHEARSAL, "cpu", cuda_lib.LAUNCHES)
        results_4b, _ = run_phase4b(REHEARSAL, REHEARSAL_MODEL, "cpu", catalogs)
        results_4c, _, _ = run_phase4c(REHEARSAL, "cpu", catalogs, hot, chain, results,
                                       results_4b, INDEX_REHEARSAL)
        serving_index(REHEARSAL, "cpu", catalogs, _warm_count(results_4c))
        oracle_path(REHEARSAL_MODEL, "cpu")
        card_vs_cpu(REHEARSAL_MODEL, "cpu")
        recurrent_paths(REHEARSAL_MODEL, "cpu")
        family_paths(REHEARSAL_MODEL, "cpu")
        served = serving_in_process(REHEARSAL_MODEL, "cpu")
        serving_fleet(REHEARSAL_MODEL, "cpu", served)
        train_row = phase11(TRAIN_REHEARSAL, "cpu")[2]
        phase12(TRAIN_REHEARSAL, REHEARSAL_MODEL, "cpu")
        phase13(DRYRUN_REHEARSAL, TRAIN_REHEARSAL, "cpu", train_row)
        phase14(TRAIN_REHEARSAL, "cpu")
        phase15(TRAIN_REHEARSAL, "cpu")
        log(f"rehearsal complete: {len(results) + len(results_4b) + len(results_4c)} "
            "queries, the Oracle queries, the recurrent paths, the model families, "
            "the serving plane, training, the mesh and the dry run on the CPU (no result)")
        sys.exit(3)
    if not torch.cuda.is_available():
        log("no CUDA card: nothing to measure")
        sys.exit(2)
    t_script = time.perf_counter()

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} bytes")

    # phase 2: build
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.rwkv6_scan.kernel import bwd_plan

    cuda_lib.build()
    info = cuda_lib.BUILD_INFO
    log(f"build: {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())
    k6_ptxas = ptxas_report(info["log"], "rwkv6_scan_bwd_kernel")
    log(json.dumps({"rwkv6_scan_bwd_kernel ptxas": k6_ptxas}))
    for hd in (16, 32, 64, 128):
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            if cuda_lib.lib().repro_rwkv6_bwd_smem_bytes(code, hd) != bwd_plan(hd, dt).smem_bytes:
                fail(f"kernel.bwd_plan's shared memory at hd {hd}, {dt} is not the kernel's")
    smem = cuda_lib.lib().repro_sim_smem_bytes
    fsmem = cuda_lib.lib().repro_flash_smem_bytes
    HIST, TOPK, SUMS = cuda_lib.HIST, cuda_lib.TOPK, cuda_lib.SUMS
    log(json.dumps({"dynamic_smem_bytes_per_cta": {
        f"sim_sweep k=32, {r}-row tile": smem(HIST | TOPK | SUMS, 4096, 32, r)
        for r in (cuda_lib.WIDE_ROWS, cuda_lib.CTA_ROWS)} | {
        "sim_hist": smem(HIST, 4096, 1, cuda_lib.WIDE_ROWS),
        "sim_topk[k=32]": smem(TOPK, 1, 32, cuda_lib.WIDE_ROWS),
        "sim_topk[k=128], 64-row tile": smem(TOPK, 1, 128, cuda_lib.CTA_ROWS),
        f"sim_topk, few-row kernels (<= {cuda_lib.FEW_ROWS} rows), scores":
            cuda_lib.lib().repro_topk_few_rows_smem_bytes(0),
        f"sim_topk, few-row kernels (<= {cuda_lib.FEW_ROWS} rows), selection":
            cuda_lib.lib().repro_topk_few_rows_smem_bytes(1)} | {
        f"flash_attention f32 d={d}": fsmem(0, d, d, 1, 1, 1, 1) for d in (64, 256)} | {
        f"flash_attention bf16 {label}": fsmem(1, *_flash_widths(sh), sh[1], sh[2], sh[3], sh[4])
        for label, sh in FLASH_SHAPES.items()} | {
        f"flash_attention_bwd bf16 {part} d={d}":
            cuda_lib.lib().repro_flash_bwd_smem_bytes(which, d)
        for which, part in ((2, "dQ"), (3, "dK/dV")) for d in (64, 256)}}))

    from repro_torch.data import make_clustered_tables
    from repro_torch.kernels import autotune

    t0 = time.perf_counter()
    ds = make_clustered_tables(FULL.n, FULL.n, d=FULL.d, n_entities=512,
                               noise=0.35, seed=SEED)
    chain = make_chain(FULL)
    log(f"phase 3 data: {time.perf_counter() - t0:.1f} s")
    # phases 3 to 4c and 10c run with the launch autotuner on (its cache in
    # build/, measured afresh); it is off again before phase 5
    tune_root = os.path.join(HERE, "build", "autotune_smoke")
    import shutil as _shutil
    _shutil.rmtree(tune_root, ignore_errors=True)
    autotune.configure(os.path.join(tune_root, "autotune.json"))
    # phase 3: kernels against their plain versions at main-path shapes
    errs = phase3(ds, FULL.slice)
    chain_err, chain_timing = chain_check(chain)
    errs["sim_sweep[fp32]"] = max(errs["sim_sweep[fp32]"], chain_err)
    del ds, chain
    _log_tuning("phase 3")
    model_rows = model_kernels()
    # phase 3c: the backward kernels (K5's, K6's, K7's)
    bwd_rows = flash_backward()
    scan_bwd_rows = scan_backwards()
    # phase 3d: the bootstrap-t's resampling (K8)
    boot_rows = bootstrap_kernels()

    # phase 4: the main path, counts read around the whole phase
    cuda_lib.reset_launches()
    results, hot, catalogs, chain = run_phase4(FULL, "cuda", cuda_lib.LAUNCHES)
    launches = dict(cuda_lib.LAUNCHES)
    log(json.dumps({"main_path_launches": launches}))
    for name in SIM_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the query path")
    retry = next(r for r in results if r["name"] == "COUNT hot rows")
    retry_rows = _stat(retry["result"], "topk_retry_rows")

    # phase 4b: the other query methods, counts set to 0 before each path
    results_4b, paths_4b = run_phase4b(FULL, FULL_MODEL, "cuda", catalogs)

    # phase 4c: the index, counts set to 0 just before each of its own calls
    # and read just after; its kernel checks at the appends' shapes.  Its
    # profiles come before phase 4 and 4b's: after the cascade's session of
    # many events the profiler loses later sessions' device events.
    rows_4c, index_launches, index_errs = run_phase4c(FULL, "cuda", catalogs, hot, chain,
                                                      results, results_4b, INDEX_FULL)
    log(json.dumps({"phase4c_launches": index_launches}))
    for name, err in index_errs.items():
        errs[name] = max(errs[name], err)
    for name in ("sim_sweep[fp32]", "sim_sweep[bf16]", "sim_sweep_q[int8]",
                 "sim_topk[k=128]"):
        if index_launches.get(name, 0) <= 0:
            fail(f"{name} was not launched by the index phase")
    profile_query(FULL, catalogs)
    profile_4b(FULL, catalogs)
    # phase 10c on phase 4's tables while they are resident: counts set to 0
    # just before its four queries and read just after
    t10 = time.perf_counter()
    index_served = serving_index(FULL, "cuda", catalogs, _warm_count(rows_4c))
    phase10_s = time.perf_counter() - t10
    del catalogs, chain, results_4b, rows_4c
    _log_tuning("phases 4 to 4c and 10c")
    autotune.reset()

    # phase 5: times at the phase-4 shapes
    ds = make_clustered_tables(FULL.n, FULL.n, d=FULL.d, n_entities=512,
                               noise=0.35, seed=SEED)
    times = phase5(ds, retry_rows, hot)
    times["sim_sweep[fp32]"].update(chain_timing)
    del ds, hot
    torch.cuda.empty_cache()

    # phases 6-9: the Oracle path, the card against the CPU, the recurrent
    # paths, the model families; counts set to 0 just before each path and
    # read just after
    paths = {"Oracle COUNT": oracle_path(FULL_MODEL, "cuda")}
    card_vs_cpu(FULL_MODEL, "cuda")
    paths.update(recurrent_paths(FULL_MODEL, "cuda"))
    # phase 9: the MoE, VLM and encoder-decoder families, one model at a time
    paths.update(family_paths(FULL_MODEL, "cuda"))
    # phase 10a-b: the serving plane with phase 6's Oracle (10c ran above)
    t10 = time.perf_counter()
    served = serving_in_process(FULL_MODEL, "cuda")
    paths["served COUNT (10a)"] = served["launches"]
    serving_fleet(FULL_MODEL, "cuda", served)
    del served
    _free()
    phase10_s += time.perf_counter() - t10
    # phase 11: training, counts set to 0 just before its steps
    t11 = time.perf_counter()
    train_launches, recurrent_launches, train_row = phase11(TRAIN_FULL, "cuda")
    paths["training (11)"] = train_launches
    for name, n in recurrent_launches.items():
        paths[f"{name} training (11b)"] = n
    _free()
    phase11_s = time.perf_counter() - t11
    # phase 12: the mesh, counts set to 0 just before each step and read just after
    t12 = time.perf_counter()
    paths.update(phase12(TRAIN_FULL, FULL_MODEL, "cuda"))
    phase12_s = time.perf_counter() - t12
    # phase 13: the dry run, the roofline against phase 11's step, the examples
    t13 = time.perf_counter()
    phase13(DRYRUN_FULL, TRAIN_FULL, "cuda", train_row)
    phase13_s = time.perf_counter() - t13
    # phase 14: the sharded step, counts set to 0 just before each step and read just after
    t14 = time.perf_counter()
    paths.update(phase14(TRAIN_FULL, "cuda"))
    phase14_s = time.perf_counter() - t14
    # phase 15: sharded prefill and decode, counts set to 0 just before each
    # prefill and decode and read just after
    t15 = time.perf_counter()
    paths.update(phase15(TRAIN_FULL, "cuda"))
    log(json.dumps({"phase10_s": phase10_s, "phase11_s": phase11_s,
                    "phase12_s": phase12_s, "phase13_s": phase13_s,
                    "phase14_s": phase14_s, "phase15_s": time.perf_counter() - t15,
                    "script_s": time.perf_counter() - t_script}))

    rows = []
    for name in SIM_KERNELS:
        rows.append({"name": name, "route": "cuda", "source": SIM_SOURCE,
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": errs[name], **times[name],
                     "launches_by_path": {"query path (4)": launches[name]} | {
                         p: n.get(name, 0) for p, n in paths_4b.items()} | {
                         "index (4c)": index_launches.get(name, 0),
                         "index via the service (10c)": index_served.get(name, 0)}})
    for name in MODEL_KERNELS:
        rows.append(model_kernel_row(name, model_rows, paths | paths_4b))
    train_row, *other_bwd = bwd_rows
    training = {p: n for p, n in paths.items() if "training" in p}
    rows.append({"name": "flash_attention_bwd", "route": "cuda", "source": MODEL_SOURCE,
                 "replaces": BWD_REPLACES,
                 "launches": train_launches.get("flash_attention_bwd", 0), **train_row,
                 "launches_by_path": {p: n.get("flash_attention_bwd", 0)
                                      for p, n in training.items()},
                 "other_shapes": other_bwd})
    scan_bwd_rows["rwkv6_scan_bwd"]["ptxas"] = k6_ptxas
    for name, arch in (("rwkv6_scan_bwd", "rwkv6-1.6b"), ("rglru_scan_bwd", "recurrentgemma-9b")):
        rows.append({"name": name, "route": "cuda", "source": MODEL_SOURCE,
                     "replaces": SCAN_BWD_REPLACES[name],
                     "launches": recurrent_launches[arch].get(name, 0), **scan_bwd_rows[name],
                     "launches_by_path": {p: n.get(name, 0) for p, n in training.items()}})
    boot_row, *other_boot = boot_rows
    rows.append({"name": "bootstrap", "route": "cuda", "source": BOOT_SOURCE,
                 "replaces": BOOT_REPLACES,
                 "launches": {k: launches.get(k, 0) for k in BOOT_KERNELS}, **boot_row,
                 "launches_by_path": {"query path (4)": {k: launches.get(k, 0)
                                                         for k in BOOT_KERNELS}} | {
                     p: {k: n.get(k, 0) for k in BOOT_KERNELS} for p, n in paths_4b.items()},
                 "other_shapes": other_boot})
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
