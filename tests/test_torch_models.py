"""The port's model stack against ``repro.models`` on the CPU: parameters
carried across with ``params_from_jax``, then the same inputs through both
forwards for every family (dense, MoE, VLM with and without patches, RWKV6,
the hybrid, the encoder-decoder), both decode steps, both caches, and the
MoE MLP at the layer level.

Tolerances, on logits, relative to the largest |logit| of the reference:
* float32: 2e-5.  Both sides compute the same f32 function (the port's
  attention runs the flash kernel's plain version, P.V in f32 as in the
  reference at f32); only the order of sums differs (measured: 2e-6).
* bfloat16: 6e-2, about 8 bf16 ulps at the logits' scale.  The two
  frameworks round to bf16 at other places (torch's silu/gelu/sigmoid
  compute in f32 and round once, JAX's in bf16), and the port's attention
  computes P.V in f32 where the reference first casts the probabilities to
  bf16; the differences compound over the layers (measured: 3.5e-2).

MoE routing at bf16: the router's input differs between the frameworks by
that bf16 rounding, so a token whose k-th and (k+1)-th router logits nearly
tie can pick another expert, and its logits then differ by far more than
6e-2.  The model-level test reads both sides' router inputs, names every
token whose top-k set differs, requires each such flip to be explained by
the inputs' difference (the reference's k-th/(k+1)-th gap is at most twice
the largest change of those logits), prints its margin, and holds the
logits at 6e-2 everywhere the flip cannot reach (the token itself, and for
a flip before the last layer every later position of its row).  At f32 no
route may flip.  At the layer level, on the same input bits, tokens are
excluded only where the gap lies inside the f32 error band of the router
product, the rule ``kernels/checks.py`` gives top-k near-ties.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as RM
import repro_torch.models.model as PM
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.layers import moe_mlp as jax_moe_mlp
from repro.models.layers import moe_params as jax_moe_params
from repro_torch.configs import get_smoke_config
from repro_torch.interop import _to_torch, params_from_jax
from repro_torch.kernels.checks import gamma
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.layers import MoE, moe_mlp, moe_route

TOL = {"float32": 2e-5, "bfloat16": 6e-2}
# the reference's decode step and MoE MLP, compiled once per config (eager,
# each call would trace its layer scan again or dispatch op by op)
jax_decode_jit = functools.partial(jax.jit, static_argnums=0)(jax_decode_step)
jax_moe_jit = functools.partial(jax.jit, static_argnums=1)(jax_moe_mlp)
# reduced configs; recurrentgemma at 5 layers = one (rec, rec, attn) block
# plus a 2-layer rec tail, so the tail branch runs too
ARCHS = {"joinml-oracle": {}, "rwkv6-1.6b": {}, "recurrentgemma-9b": {"num_layers": 5},
         "olmoe-1b-7b": {}, "qwen3-moe-235b-a22b": {}, "whisper-medium": {},
         "pixtral-12b": {}}
# forward cases: an arch, or the VLM with its patches
FORWARDS = list(ARCHS) + ["pixtral-12b+patches"]
MOE = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")

_CACHE: dict = {}


def _models(arch, dtype):
    """(reference cfg, reference params, port cfg, port params), built once."""
    key = (arch, dtype)
    if key not in _CACHE:
        over = dict(ARCHS.get(arch, {}), dtype=dtype)
        rcfg = jax_smoke_config(arch, **over)
        rparams = jax_init_params(rcfg, jax.random.key(7))
        cfg = get_smoke_config(arch, **over)
        params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
        _CACHE[key] = (rcfg, rparams, cfg, params)
    return _CACHE[key]


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _batch(cfg, b, s, seed, patches=False):
    """Numpy inputs: tokens, and the frames or patches the family reads."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if patches:
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_jax_carries_every_leaf(arch, dtype):
    rcfg, rparams, cfg, params = _models(arch, dtype)
    leaves = jax.tree_util.tree_flatten_with_path(rparams)[0]
    n_ref = sum(int(np.prod(x.shape)) for _, x in leaves)
    assert n_ref == sum(p.numel() for p in params.parameters())
    got = dict(params.named_parameters())
    for path, leaf in leaves:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        stacked = keys[0] in ("layers", "enc", "blocks")
        for i in range(leaf.shape[0] if stacked else 1):
            name = ".".join(map(str, [keys[0], i, *keys[1:]] if stacked else keys))
            want = leaf[i] if stacked else leaf
            t = got[name]
            assert str(t.dtype).removeprefix("torch.") == str(want.dtype), name
            np.testing.assert_array_equal(t.float().numpy(), _f32(want), err_msg=name)


def test_params_from_jax_refuses_a_changed_tree():
    """A missing, an extra or a retyped leaf raises (an MoE tree with an
    encoder-decoder's and a VLM's leaves beside it)."""
    rcfg, rparams, cfg, _ = _models("olmoe-1b-7b", "float32")
    tree = jax.tree.map(np.asarray, rparams)
    missing = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "moe"})
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cfg, missing, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(cfg, dict(tree, patch_proj=np.zeros((64, 64), np.float32)),
                        device="cpu")
    moe = dict(tree["layers"]["moe"], router=tree["layers"]["moe"]["router"].astype(np.float16))
    with pytest.raises(ValueError, match="router"):
        params_from_jax(cfg, dict(tree, layers=dict(tree["layers"], moe=moe)), device="cpu")


def _capture_moe_inputs(monkeypatch):
    """Record the input of every ``moe_mlp`` call of both packages, in
    layer order: the reference's through an ordered debug callback (its
    layers run inside ``lax.scan``)."""
    seen = {"ref": [], "port": []}
    ref_moe, port_moe = RM.moe_mlp, PM.moe_mlp

    def ref_spy(p, cfg, x):
        jax.debug.callback(lambda a: seen["ref"].append(_f32(a)), x, ordered=True)
        return ref_moe(p, cfg, x)

    def port_spy(p, cfg, x):
        seen["port"].append(x.float().numpy())
        return port_moe(p, cfg, x)

    monkeypatch.setattr(RM, "moe_mlp", ref_spy)
    monkeypatch.setattr(PM, "moe_mlp", port_spy)
    return seen


def _route_flips(cfg, params, seen):
    """Positions (b, s) each flip can reach, and the flips' margins: a
    token flips at a layer when the top-k sets of the two sides' router
    logits (f64, from each side's input) differ."""
    k, n_layers = cfg.num_experts_per_tok, cfg.num_layers
    reach, margins = set(), []
    for layer, (xr, xp) in enumerate(zip(seen["ref"], seen["port"])):
        router = params.layers[layer].moe.router.double().numpy()
        lr, lp = xr.astype(np.float64) @ router, xp.astype(np.float64) @ router
        top_r = np.sort(np.argsort(-lr, axis=-1)[..., :k], -1)
        top_p = np.sort(np.argsort(-lp, axis=-1)[..., :k], -1)
        for b, s in zip(*np.nonzero((top_r != top_p).any(-1))):
            srt = np.sort(lr[b, s])[::-1]
            gap, moved = srt[k - 1] - srt[k], np.abs(lr[b, s] - lp[b, s]).max()
            margins.append({"layer": layer, "pos": (int(b), int(s)), "gap": float(gap),
                            "logit_change": float(moved)})
            assert gap <= 2 * moved, margins[-1]  # the inputs' difference explains it
            last = layer == n_layers - 1
            reach |= {(int(b), t) for t in range(s, s + 1 if last else xr.shape[1])}
    return reach, margins


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FORWARDS)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    arch, _, with_patches = arch.partition("+")
    rcfg, rparams, cfg, params = _models(arch, dtype)
    batch = _batch(cfg, 2, 21, seed=1, patches=bool(with_patches))
    seen = _capture_moe_inputs(monkeypatch) if arch in MOE else None
    want = _f32(jax_forward(rcfg, rparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = forward(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert want.shape[1] == 21 + (cfg.num_patches if with_patches else 0)
    err = np.abs(got.float().numpy() - want).max(-1)
    if seen is not None:
        reach, margins = _route_flips(cfg, params, seen)
        print(f"{arch} {dtype}: route flips {margins}")
        assert not (dtype == "float32" and margins)
        for b, s in reach:
            err[b, s] = 0.0
        assert len(reach) <= 3, margins  # near-ties are rare
    assert err.max() <= TOL[dtype] * np.abs(want).max(), (err.max(), np.abs(want).max())


def _moe_pair(dtype, **over):
    """The reference's MoE parameters and the port's ``MoE`` holding them."""
    rcfg = jax_smoke_config("olmoe-1b-7b", dtype=dtype, **over)
    cfg = get_smoke_config("olmoe-1b-7b", dtype=dtype, **over)
    rp = jax_moe_params(jax.random.key(3), rcfg)
    p = MoE(cfg, torch.Generator().manual_seed(0))
    for name, leaf in rp.items():
        getattr(p, name).copy_(_to_torch(np.asarray(leaf)))
    return rcfg, rp, cfg, p


def _router_near_ties(x, router, k):
    """Tokens whose k-th and (k+1)-th router logits lie within twice the
    f32 error band of the router product: either side may order them
    either way.  x: (T, d) f32 bits both sides see."""
    a, r = x.astype(np.float64), router.astype(np.float64)
    logits = a @ r
    band = gamma(a.shape[1]) * (np.abs(a) @ np.abs(r))
    order = np.argsort(-logits, axis=-1)
    rows = np.arange(len(a))
    kth, nxt = order[:, k - 1], order[:, k]
    gap = logits[rows, kth] - logits[rows, nxt]
    return gap <= 2 * (band[rows, kth] + band[rows, nxt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_reference(dtype):
    """On the same input bits, the port's ``moe_mlp`` equals the
    reference's: f32 within 2e-5 of the largest |output|, bf16 within 2**-5
    of it (four bf16 ulps: both round each expert product and the combine
    to bf16, at other places); near-tie tokens are excluded (none here)."""
    rcfg, rp, cfg, p = _moe_pair(dtype)
    x = np.random.default_rng(0).standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = _to_torch(np.asarray(xj))
    want = _f32(jax_moe_jit(rp, rcfg, xj)).reshape(48, -1)
    got = moe_mlp(p, cfg, xt).float().numpy().reshape(48, -1)
    near = _router_near_ties(_f32(xj).reshape(48, -1), np.asarray(rp["router"]),
                             cfg.num_experts_per_tok)
    err = np.abs(got - want)[~near]
    tol = {"float32": 2e-5, "bfloat16": 2.0**-5}[dtype]
    assert err.max() <= tol * np.abs(want).max(), (err.max(), np.abs(want).max())


def _reference_keep(rp, rcfg, x):
    """The reference's kept (token, choice) pairs, by its own steps
    (``layers.py:332-358``: f32 router softmax, ``lax.top_k``, the stable
    ``jnp.argsort`` and the per-expert positions), as a (T, k) mask."""
    e, k = rcfg.num_experts, rcfg.num_experts_per_tok
    t = x.shape[0]
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ rp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = max(int(np.ceil(t * k / e * rcfg.moe_capacity_factor)), 1)
    flat_e = top_e.reshape(t * k)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    pos_in_e = jnp.arange(t * k) - jnp.searchsorted(e_sorted, jnp.arange(e))[e_sorted]
    keep = np.zeros(t * k, bool)
    keep[np.asarray(order)] = np.asarray(pos_in_e < cap)
    return keep.reshape(t, k), np.asarray(top_e)


def test_moe_mlp_capacity_drops_like_reference():
    """Four experts, top 2, capacity factor 1.0 over 2 x 12 tokens: some
    (token, choice) pairs overflow their expert and are dropped, in the
    order of the stable argsort.  At f32 the port keeps exactly the
    reference's pairs, its output equals the reference's within 2e-5, and a
    token that lost both choices comes out exactly zero on both sides."""
    over = dict(num_experts=4, num_experts_per_tok=2, moe_capacity_factor=1.0)
    rcfg, rp, cfg, p = _moe_pair("float32", **over)
    x = np.random.default_rng(5).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    want = _f32(jax_moe_jit(rp, rcfg, jnp.asarray(x))).reshape(24, -1)
    got = moe_mlp(p, cfg, xt).numpy().reshape(24, -1)
    top_e, _, keep, _ = moe_route(p, cfg, xt.reshape(24, -1))
    ref_keep, ref_top = _reference_keep(rp, rcfg, x.reshape(24, -1))
    assert not _router_near_ties(x.reshape(24, -1), np.asarray(rp["router"]), 2).any()
    np.testing.assert_array_equal(top_e.numpy(), ref_top)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert (~ref_keep).sum() > 0
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    gone = ~ref_keep.any(-1)
    assert (got[gone] == 0).all() and (want[gone] == 0).all()


def test_moe_combine_is_deterministic():
    """The same batch gives the same bits: the k contributions of a token
    are summed in (token, choice) order, not scattered with atomics."""
    _, _, cfg, p = _moe_pair("bfloat16")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 9, cfg.d_model)).astype(np.float32)).bfloat16()
    assert torch.equal(moe_mlp(p, cfg, x), moe_mlp(p, cfg, x))


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_reference(per_slot):
    """Token by token through both decode steps, at f32, on a dense config
    with qkv bias (qwen2): the logits agree within the f32 tolerance and the
    caches hold the same K/V rows."""
    rcfg = jax_smoke_config("qwen2-1.5b", dtype="float32")
    rparams = jax_init_params(rcfg, jax.random.key(3))
    cfg = get_smoke_config("qwen2-1.5b", dtype="float32")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    b, s, t_max = 3, 6, 10
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    rcache = jax_init_cache(rcfg, b, t_max)
    cache = init_cache(cfg, b, t_max, device="cpu")
    # per-slot positions start the rows at different offsets, as continuous
    # batching does after a mid-flight admission
    start = np.array([0, 2, 1]) if per_slot else np.zeros(b, np.int64)
    for t in range(s):
        pos = start + t
        rpos = jnp.asarray(pos, jnp.int32) if per_slot else jnp.int32(t)
        ppos = torch.from_numpy(pos) if per_slot else t
        want, rcache = jax_decode_jit(rcfg, rparams, rcache,
                                      jnp.asarray(tokens[:, t:t + 1]), rpos)
        got, cache = decode_step(cfg, params, cache, torch.from_numpy(tokens[:, t:t + 1]), ppos)
        want = _f32(want)
        assert np.abs(got.numpy() - want).max() <= TOL["float32"] * np.abs(want).max()
    np.testing.assert_allclose(cache["k"].numpy(), _f32(rcache["k"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache["v"].numpy(), _f32(rcache["v"]), rtol=0, atol=1e-5)


def test_decode_reproduces_forward_and_prefill():
    """Inside the port: decoding a sequence token by token gives the
    full-sequence forward's logits (f32), and prefill returns the forward's
    logits with an empty cache, as the reference's prefill does."""
    cfg = get_smoke_config("llama3.2-1b", dtype="float32")
    params = init_params(cfg, seed=5, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    full = forward(cfg, params, {"tokens": tokens})
    cache = init_cache(cfg, 2, 12, device="cpu")
    steps = [decode_step(cfg, params, cache, tokens[:, t:t + 1], t)[0] for t in range(8)]
    torch.testing.assert_close(torch.stack(steps, dim=1), full, rtol=0, atol=1e-5)
    logits, fresh = prefill(cfg, params, {"tokens": tokens}, 12)
    assert torch.equal(logits, full)
    assert fresh["k"].shape == (cfg.num_layers, 2, 12, cfg.num_kv_heads, cfg.head_dim)
    assert not fresh["k"].any()


def test_init_params_scales_and_types():
    """The port draws its own weights (seeded torch.Generator) at the
    reference's scales: embed 0.02, dense 1/sqrt(fan_in), norms at 0."""
    cfg = get_smoke_config("joinml-oracle")
    a = init_params(cfg, seed=0, device="cpu")
    b = init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert a.embed.dtype == torch.bfloat16 and a.ln_f.dtype == torch.float32
    assert abs(float(a.embed.float().std()) - 0.02) < 2e-3
    wq = a.layers[0].attn.wq.float()
    assert abs(float(wq.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("arch,kind", [("rwkv6-1.6b", "rwkv"), ("recurrentgemma-9b", "rglru")])
def test_recurrent_state_init_matches_reference(arch, kind):
    """The zero states decode will carry (forward builds only the zeros it
    reads) have the reference's keys, shapes and types."""
    from repro.models import recurrent as R
    from repro_torch.models import recurrent as P

    rcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    want = getattr(R, f"{kind}_state_init")(rcfg, 3)
    got = getattr(P, f"{kind}_state_init")(cfg, 3, "cpu")
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert str(t.dtype).removeprefix("torch.") == str(want[key].dtype), key
        assert not t.any()


# decode: every family but dense (held above on qwen2); per-slot positions
# where the cache is positional.  The hybrid's ring is 5 slots, so 7 steps
# wrap it.
DECODES = [("olmoe-1b-7b", False), ("olmoe-1b-7b", True), ("rwkv6-1.6b", False),
           ("recurrentgemma-9b", False), ("whisper-medium", False),
           ("whisper-medium", True), ("pixtral-12b", True)]


@pytest.mark.parametrize("arch,per_slot", DECODES)
def test_decode_step_matches_reference_for_every_family(arch, per_slot):
    """Token by token through both decode steps at f32: the logits agree
    within 2e-5 of their largest magnitude at every step, and every leaf of
    the two caches (K/V rows, RWKV6 and RG-LRU states, ring buffers, the
    encoder-decoder's frames) within 2e-5 of its largest magnitude."""
    rcfg, rparams, cfg, params = _models(arch, "float32")
    assert cfg.has_positional_cache or not per_slot
    b, s = 3, 7
    t_max = 5 if cfg.family == "hybrid" else 10
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    rcache = jax_init_cache(rcfg, b, t_max)
    cache = init_cache(cfg, b, t_max, device="cpu")
    start = np.array([0, 2, 1]) if per_slot else np.zeros(b, np.int64)
    for t in range(s):
        pos = start + t
        rpos = jnp.asarray(pos, jnp.int32) if per_slot else jnp.int32(t)
        ppos = torch.from_numpy(pos) if per_slot else t
        want, rcache = jax_decode_jit(rcfg, rparams, rcache,
                                      jnp.asarray(tokens[:, t:t + 1]), rpos)
        got, cache = decode_step(cfg, params, cache, torch.from_numpy(tokens[:, t:t + 1]), ppos)
        want = _f32(want)
        assert np.abs(got.numpy() - want).max() <= TOL["float32"] * np.abs(want).max(), t
    got_leaves, want_leaves = _leaves(cache), _leaves(rcache)
    assert got_leaves.keys() == want_leaves.keys()
    for name, leaf in want_leaves.items():
        want = _f32(leaf)
        err = np.abs(got_leaves[name].float().numpy() - want).max()
        assert err <= TOL["float32"] * max(np.abs(want).max(), 1.0), name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-1.6b", "recurrentgemma-9b"])
def test_decode_matches_forward(arch):
    """The mirror of the reference's ``test_decode_matches_forward``:
    feeding tokens one by one through ``decode_step`` reproduces the
    full-sequence forward's logits (here at f32, within 2e-5 of the largest
    |logit|; the carried RWKV6 and RG-LRU states against K6's and K7's
    plain versions from zero), and the greedy tokens agree."""
    cfg = get_smoke_config(arch, dtype="float32", **ARCHS[arch])
    params = init_params(cfg, seed=1, device="cpu")
    b, s = 2, 8
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    full = forward(cfg, params, {"tokens": tokens})
    cache = init_cache(cfg, b, s + 4, device="cpu")
    steps = torch.stack([decode_step(cfg, params, cache, tokens[:, t:t + 1], t)[0]
                         for t in range(s)], dim=1)
    assert float((steps - full).abs().max()) <= 2e-5 * float(full.abs().max())
    assert torch.equal(steps[:, -1].argmax(-1), full[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_cache_and_prefill_match_reference(arch):
    """``init_cache`` builds the reference's tree (keys, shapes, types, all
    zero) for every family, and ``prefill`` returns the forward's logits
    with such a fresh cache, as the reference's does."""
    rcfg, rparams, cfg, params = _models(arch, "bfloat16")
    want = _leaves(jax_init_cache(rcfg, 3, 16))
    got = _leaves(init_cache(cfg, 3, 16, device="cpu"))
    assert got.keys() == want.keys()
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
        assert not got[name].any(), name
    batch = _batch(cfg, 2, 9, seed=6)
    logits, fresh = prefill(cfg, params, batch, 16)
    assert torch.equal(logits, forward(cfg, params, batch))
    # the reference's prefill traced for its shapes only (its logits are
    # held against the port's by test_forward_matches_reference)
    rlogits, rfresh = jax.eval_shape(lambda p, x: jax_prefill(rcfg, p, x, 16), rparams,
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    assert logits.shape == rlogits.shape
    assert {k: tuple(v.shape) for k, v in _leaves(fresh).items()} == {
        k: v.shape for k, v in _leaves(rfresh).items()}
