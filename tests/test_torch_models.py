"""The port's model stack against ``repro.models`` on the CPU: parameters
carried across with ``params_from_jax``, then the same tokens through both
forwards (and both decode steps for a dense config).

Tolerances, on logits, relative to the largest |logit| of the reference:
* float32: 2e-5.  Both sides compute the same f32 function (the port's
  attention runs the flash kernel's plain version, P.V in f32 as in the
  reference at f32); only the order of sums differs (measured: 2e-6).
* bfloat16: 6e-2, about 8 bf16 ulps at the logits' scale.  The two
  frameworks round to bf16 at other places (torch's silu/gelu/sigmoid
  compute in f32 and round once, JAX's in bf16), and the port's attention
  computes P.V in f32 where the reference first casts the probabilities to
  bf16; the differences compound over the layers (measured: 3.5e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill

TOL = {"float32": 2e-5, "bfloat16": 6e-2}
# reduced configs; recurrentgemma at 5 layers = one (rec, rec, attn) block
# plus a 2-layer rec tail, so the tail branch runs too
ARCHS = {"joinml-oracle": {}, "rwkv6-1.6b": {}, "recurrentgemma-9b": {"num_layers": 5}}

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
        stacked = keys[0] in ("layers", "blocks")
        for i in range(leaf.shape[0] if stacked else 1):
            name = ".".join(map(str, [keys[0], i, *keys[1:]] if stacked else keys))
            want = leaf[i] if stacked else leaf
            t = got[name]
            assert str(t.dtype).removeprefix("torch.") == str(want.dtype), name
            np.testing.assert_array_equal(t.float().numpy(), _f32(want), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_reference(arch, dtype):
    rcfg, rparams, cfg, params = _models(arch, dtype)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    want = _f32(jax_forward(rcfg, rparams, {"tokens": jnp.asarray(tokens)}))
    got = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), (err, np.abs(want).max())


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
        want, rcache = jax_decode_step(rcfg, rparams, rcache,
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


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-medium", "pixtral-12b"])
def test_families_not_ported_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(get_smoke_config(arch), device="cpu")
