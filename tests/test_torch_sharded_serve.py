"""The data-parallel pair scorer (``PairScorer(mesh=)`` over a one-process
mesh, ``launch.sharding.data_parallel``) and the launcher's ``--shard``.

* On one-process meshes of 1 and 4 CPU slots the sharded scorer equals the
  unsharded one, as ``tests/test_oracle_batch.py`` requires of the
  reference's: within 1e-5 of P(match) at f32 (``tests/test_torch_serve.py``'s
  rule) and 2e-2 at bf16 (the reference's own sharded-against-unsharded
  tolerance, and ``chip_smoke.py``'s card-against-CPU rule for P at bf16).
  On 4 slots each slice's forward runs at a quarter of the batch.  Even on 1
  slot, where the shapes and ops are the same, the CPU's threaded f32
  reductions do not give the same bits on every run (measured: 6 of 37
  probabilities off by up to 7.6e-7 in one run of two), so bit identity is
  asserted on the card only (``chip_smoke.py`` phase 12b).
* An MoE (``olmoe-1b-7b``'s smoke config at f32 with capacity factor 1, so
  that pairs overflow) on 4 slots keeps, layer by layer and slice by slice,
  the (token, choice) pairs the reference's sharded scorer keeps on 4
  forced host devices, where each ``shard_map`` shard routes its quarter of
  the batch alone.  The reference's router inputs are read by a
  ``jax.debug.callback`` in its ``moe_mlp`` with the shard's
  ``axis_index``; its kept pairs follow by its own routing steps; the
  port's inputs must agree with them within 2e-5 of their largest |x|
  (which also checks that the records line up).  P(match) agrees within
  1e-5, and the sharded scorer differs from the unsharded one: capacity is
  per slice.
* ``python -m repro_torch.launch.serve --mode score --shard --device cpu``
  prints the reference's mesh line and exits 0.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.models.layers as PL
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import ByteTokenizer, pair_example
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.serve import PairScorer

from torch_ranks import SRC, finish, run_reference, unflatten_paths

N_SIDE = 40
REC1 = [f"acme unit {i:03d}" for i in range(N_SIDE)]
REC2 = [f"acme dept {j:03d} north" for j in range(N_SIDE)]
MOE_OVER = dict(dtype="float32", moe_capacity_factor=1.0)


def _tok_pair(tok, pair_example_fn):
    def tok_pair(pair):
        t, _ = pair_example_fn(tok, REC1[pair[0]], REC2[pair[1]], None, 48)
        return t[t != tok.PAD]
    return tok_pair


def _pairs(n, seed):
    return np.random.default_rng(seed).integers(0, N_SIDE, size=(n, 2))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_sharded_scorer_equals_unsharded(dtype, tol):
    tok = ByteTokenizer()
    cfg = get_smoke_config("joinml-oracle", vocab_size=tok.vocab_size, dtype=dtype)
    params = init_params(cfg, seed=0, device="cpu")
    tp = _tok_pair(tok, pair_example)
    plain = PairScorer(cfg, params, tp, tok.YES, tok.NO, max_len=48, batch_size=16,
                       device="cpu")
    pairs = _pairs(37, 1)
    want = plain.score(pairs)
    one = PairScorer(cfg, params, tp, tok.YES, tok.NO, max_len=48, batch_size=16,
                     mesh=make_host_mesh(device="cpu"), device="cpu")
    np.testing.assert_allclose(one.score(pairs), want, rtol=0, atol=tol)
    four = PairScorer(cfg, params, tp, tok.YES, tok.NO, max_len=48, batch_size=14,
                      mesh=make_host_mesh(devices=["cpu"] * 4), device="cpu")
    assert four.batch_size == 16          # rounded up to a multiple of 4 slices
    np.testing.assert_allclose(four.score(pairs), want, rtol=0, atol=tol)
    assert four.forward_batches == plain.forward_batches == one.forward_batches
    assert four.pairs_scored == 37


REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
import repro.models.model as RM
from repro.configs import get_smoke_config
from repro.data.pipeline import ByteTokenizer, pair_example
from repro.launch.mesh import make_host_mesh
from repro.models import init_params
from repro.serve.serve_loop import PairScorer

out, over = sys.argv[1], json.loads(sys.argv[2])
pairs = np.asarray(json.loads(sys.argv[3]))
rec1 = [f"acme unit {i:03d}" for i in range(40)]
rec2 = [f"acme dept {j:03d} north" for j in range(40)]
tok = ByteTokenizer()
cfg = get_smoke_config("olmoe-1b-7b", vocab_size=tok.vocab_size, **over)
params = init_params(cfg, jax.random.key(0))

def tp(pair):
    t, _ = pair_example(tok, rec1[pair[0]], rec2[pair[1]], None, 48)
    return t[t != tok.PAD]

seen = []
moe = RM.moe_mlp

def spy(p, c, x):
    jax.debug.callback(lambda i, a: seen.append((int(i), np.asarray(a, np.float32))),
                       jax.lax.axis_index("data"), x)
    return moe(p, c, x)

RM.moe_mlp = spy
mesh = make_host_mesh()
assert dict(mesh.shape) == {"data": 4, "model": 1}
scorer = PairScorer(cfg, params, tp, tok.YES, tok.NO, max_len=48, batch_size=16, mesh=mesh)
probs = scorer.score(pairs)
by_shard = {}
for shard, x in seen:
    by_shard.setdefault(shard, []).append(x)
flat = jax.tree_util.tree_flatten_with_path(params)[0]
np.savez(out + "/olmoe.npz", **{"/".join(k.key for k in path): np.asarray(l) for path, l in flat})
np.savez(out + "/seen.npz", **{f"{s}_{i}": x for s, xs in by_shard.items()
                               for i, x in enumerate(xs)})
print(json.dumps({"probs": probs.tolist(), "forward_batches": scorer.forward_batches,
                  "calls": {str(s): len(xs) for s, xs in by_shard.items()}}))
"""


def _reference_keep(router, cfg, x):
    """The reference's kept (token, choice) pairs of (T, d) tokens, by its
    own routing steps (``tests/test_torch_models.py``)."""
    e, k, t = cfg.num_experts, cfg.num_experts_per_tok, x.shape[0]
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ jnp.asarray(router), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = max(int(np.ceil(t * k / e * cfg.moe_capacity_factor)), 1)
    flat_e = top_e.reshape(t * k)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(e_sorted, jnp.arange(e))[e_sorted]
    keep = np.zeros(t * k, bool)
    keep[np.asarray(order)] = np.asarray(pos < cap)
    return keep.reshape(t, k)


def test_sharded_moe_scorer_keeps_the_references_pairs(tmp_path, monkeypatch):
    tok = ByteTokenizer()
    pairs = _pairs(16, 2)   # one padded batch of the 48-token bucket
    proc = run_reference(REFERENCE, 4, args=[str(tmp_path), json.dumps(MOE_OVER),
                                             json.dumps(pairs.tolist())])
    ref = json.loads(finish(proc).strip().splitlines()[-1])
    cfg = get_smoke_config("olmoe-1b-7b", vocab_size=tok.vocab_size, **MOE_OVER)
    params = params_from_jax(cfg, unflatten_paths(dict(np.load(tmp_path / "olmoe.npz"))),
                             device="cpu")
    seen = []
    route = PL.moe_route

    def spy(p, c, xt):
        out = route(p, c, xt)
        seen.append((xt.detach().float().numpy().copy(), out[2].numpy().copy()))
        return out

    monkeypatch.setattr(PL, "moe_route", spy)
    tp = _tok_pair(tok, pair_example)
    sharded = PairScorer(cfg, params, tp, tok.YES, tok.NO, max_len=48, batch_size=16,
                         mesh=make_host_mesh(devices=["cpu"] * 4), device="cpu")
    got = sharded.score(pairs)
    np.testing.assert_allclose(got, ref["probs"], rtol=0, atol=1e-5)
    assert sharded.forward_batches == ref["forward_batches"] == 1
    # the slices run one after another, each through every layer
    n_layers = cfg.num_layers
    assert ref["calls"] == {str(s): n_layers for s in range(4)}
    assert len(seen) == 4 * n_layers
    recorded = np.load(tmp_path / "seen.npz")
    dropped = 0
    for s in range(4):
        for layer in range(n_layers):
            x_ref = recorded[f"{s}_{layer}"].reshape(-1, cfg.d_model)
            x_port, keep = seen[s * n_layers + layer]
            assert np.abs(x_port - x_ref).max() <= 2e-5 * np.abs(x_ref).max(), (s, layer)
            router = params.layers[layer].moe.router.detach().numpy()
            np.testing.assert_array_equal(keep, _reference_keep(router, cfg, x_ref),
                                          err_msg=f"slice {s}, layer {layer}")
            dropped += int((~keep).sum())
    assert dropped > 0
    monkeypatch.setattr(PL, "moe_route", route)
    plain = PairScorer(cfg, params, tp, tok.YES, tok.NO, max_len=48, batch_size=16,
                       device="cpu")
    assert np.abs(plain.score(pairs) - got).max() > 1e-4, "capacity is not per slice"


def test_launcher_scores_over_the_host_mesh():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "joinml-oracle",
         "--mode", "score", "--shard", "--pairs", "32", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] sharding score batches over mesh {'data': 1, 'model': 1}" in out.stdout
    assert "scored 32 pairs" in out.stdout
