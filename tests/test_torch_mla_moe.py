"""DeepSeek-V3's blocks in the port (latent attention, the sigmoid router
with its selection bias, shared experts, the dropless dispatch, a dense
layer before the MoE ones) held to the plain f32 reference
``tests/ref_moonlight.py`` on seeded weights at small widths on the CPU;
the capacity path that the OLMoE cells serve held to its output before
these options existed (``fixtures/olmoe_smoke_forward.npz``, the parent
tree's forward at seed 3).

Tolerances.  Port and reference both compute in f32 and differ only in
the order of their sums (the port concatenates q's and k's nope and rope
parts and runs one product; the reference sums the two products; the
experts' products run over other row blocks), so they agree to a few f32
roundings of the largest value: ``F32`` (1e-5 of it) leaves an order of
magnitude above the 1e-6 readings.  Each test also computes what a lower
precision or a dropped term gives and requires it to lie past the
tolerance, so the tolerance is not so loose that a bf16 forward, a router
without its bias or a missing shared expert would pass.

The card's tests (``-m cuda``): the model at three layers of the published
widths in bf16 on the card against the reference, and the grouped expert
products against the per-expert ones.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ref_moonlight as R
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import forward, init_cache, init_params, layers
from repro_torch.models.layers import (
    moe_capacity_mlp,
    moe_dropless_mlp,
    moe_mlp,
    moe_select,
)
from repro_torch.obs import telemetry

F32 = 1e-5
YES, NO = 5, 6


def small_cfg(dtype="float32", **over):
    """Moonlight's structure at small widths: one dense layer, then MoE
    layers of 8 experts, 2 a token, one shared; q and k 24 wide, v 16."""
    base = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=0,
                d_ff=96, vocab_size=320, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, num_experts=8, num_experts_per_tok=2,
                moe_d_ff=32, shared_experts=1, dtype=dtype)
    base.update(over)
    return dataclasses.replace(get_config("moonlight-16b-a3b"), **base)


def model_of(cfg, seed=0, bias_std=0.1):
    """Seeded parameters with the router biases drawn (``init_params``
    leaves them 0), and the reference's name -> tensor view of them."""
    params = init_params(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name, p in params.named_parameters():
        if name.endswith("router_bias"):
            p.copy_(torch.randn(p.shape, generator=g) * bias_std)
    return params, {n: p.detach() for n, p in params.named_parameters()}


def ref_model(cfg):
    return dataclasses.asdict(cfg)


def rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max())


def hidden(cfg, b=3, s=20, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, cfg.d_model, generator=g)


# ---- latent attention ------------------------------------------------------

def test_mla_matches_reference():
    """q and k 24 wide, v 16 (K5's plain version at two widths).  The
    bf16-rounded input and weights miss by more.  A q LoRA is refused."""
    with pytest.raises(ValueError):
        small_cfg(q_lora_rank=24)
    cfg = small_cfg()
    params, w = model_of(cfg)
    x = hidden(cfg)
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    attn = params.layers[0].attn
    got = layers.mla_attention(attn, cfg, x, pos)
    lw = R.layer_weights(w, 0)
    want = R.mla(x, lw, ref_model(cfg))
    assert got.shape == (3, 20, cfg.d_model)
    assert rel(got, want) <= F32
    low = R.mla(x.bfloat16().float(), {k: t.bfloat16().float() for k, t in lw.items()},
                ref_model(cfg))
    assert rel(low, want) > F32


def test_rope_pairs_adjacent_dims():
    """The port rotates the pairs (2i, 2i + 1) gathered into halves; the
    reference in place: the same rotation in another order of dims."""
    x = torch.randn(2, 3, 11, 8)
    pos = torch.arange(11)[None, None, :]
    got = layers.apply_rope_interleaved(x, pos, 50_000.0)
    want = R.rope(x, 50_000.0)
    torch.testing.assert_close(got, torch.cat([want[..., 0::2], want[..., 1::2]], -1))


def test_kernel_ref_takes_two_widths():
    """K5's plain version at q/k 24 and v 16 against the softmax written out
    at q's width**-0.5, causal."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator().manual_seed(4)
    q, k = torch.randn(2, 3, 9, 24, generator=g), torch.randn(2, 3, 9, 24, generator=g)
    v = torch.randn(2, 3, 9, 16, generator=g)
    got = flash_attention_ref(q, k, v, causal=True)
    s = (q @ k.transpose(-1, -2)) * 24**-0.5
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), float("-inf"))
    want = torch.softmax(s, -1) @ v
    assert got.shape == (2, 3, 9, 16)
    assert rel(got, want) <= F32


def test_mla_refuses_decode_and_unequal_grad():
    cfg = small_cfg()
    with pytest.raises(NotImplementedError):
        init_cache(cfg, 2, 8, device="cpu")
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros(1, 1, 4, 24, device="meta", requires_grad=True)
    v = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, v)
    out = flash_attention(q.detach(), q.detach(), v)
    assert out.shape == (1, 1, 4, 16)


# ---- the router --------------------------------------------------------------

@pytest.mark.parametrize("norm,scale", [(True, 2.446), (False, 1.0), (True, 1.0)])
def test_sigmoid_router_matches_reference(norm, scale):
    """Experts chosen by score + bias, weighed by the scores alone (then
    renormalised and scaled as configured): the same experts, the weights
    to f32 rounding.  Without the bias a share of tokens picks others."""
    cfg = small_cfg(norm_topk_prob=norm, routed_scaling_factor=scale)
    params, w = model_of(cfg)
    moe = params.layers[1].moe
    xt = hidden(cfg).reshape(-1, cfg.d_model)
    top_e, top_w = moe_select(moe, cfg, xt)
    sel, wts, _ = R.route(xt, R.layer_weights(w, 1), ref_model(cfg))
    assert torch.equal(top_e, sel)
    assert rel(top_w, wts) <= 1e-6
    if norm:
        torch.testing.assert_close(top_w.sum(-1), torch.full((60,), scale), rtol=1e-6, atol=0)
    unbiased = torch.topk(torch.sigmoid(xt @ moe.router), 2).indices
    changed = (unbiased.sort(-1).values != sel.sort(-1).values).any(-1).float().mean()
    assert changed >= 0.1


def test_softmax_route_is_the_default():
    """A config without the new options routes as before: softmax, top k,
    renormalised, no bias."""
    cfg = get_smoke_config("olmoe-1b-7b", dtype="float32")
    assert (cfg.router, cfg.router_bias, cfg.norm_topk_prob, cfg.routed_scaling_factor,
            cfg.shared_experts, cfg.first_dense_layers) == ("softmax", False, True, 1.0, 0, 0)
    params = init_params(cfg, seed=1, device="cpu")
    moe = params.layers[0].moe
    xt = hidden(cfg, seed=5).reshape(-1, cfg.d_model)
    top_e, top_w = moe_select(moe, cfg, xt)
    probs = torch.softmax(xt @ moe.router, -1)
    want_w, want_e = torch.topk(probs, 2)
    assert torch.equal(top_e, want_e)
    assert torch.equal(top_w, want_w / want_w.sum(-1, keepdim=True).clamp_min(1e-9))


# ---- the experts -------------------------------------------------------------

def test_shared_expert_and_dropless_match_reference():
    """Routed experts (dropless) plus the shared one against the
    reference's expert loop; without the shared expert the layer misses
    by far more."""
    cfg = small_cfg()
    params, w = model_of(cfg)
    moe = params.layers[1].moe
    x = hidden(cfg)
    got = moe_mlp(moe, cfg, x)
    want = R.moe(x, R.layer_weights(w, 1), ref_model(cfg))[0]
    assert rel(got, want) <= F32
    assert rel(moe_dropless_mlp(moe, cfg, x), want) > 100 * F32


def test_dropless_equals_capacity_that_drops_nothing():
    """At a capacity factor of E / k every pair keeps its slot, so the
    capacity dispatch computes what the dropless one does (the products
    over other row blocks: f32 rounding)."""
    cfg = small_cfg()
    params, _ = model_of(cfg)
    moe = params.layers[1].moe
    x = hidden(cfg)
    roomy = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    got, want = moe_dropless_mlp(moe, cfg, x), moe_capacity_mlp(moe, roomy, x)
    assert rel(got, want) <= 1e-6
    tight = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    assert rel(moe_capacity_mlp(moe, tight, x), want) > 100 * F32


def test_grouped_products_equal_the_per_expert_ones():
    """The one grouped product over device offsets (the card's path) against
    one product an expert, where this torch has ``_grouped_mm`` on the CPU."""
    cfg = small_cfg()
    params, _ = model_of(cfg)
    moe = params.layers[1].moe
    x = hidden(cfg)
    try:
        got = moe_dropless_mlp(moe, cfg, x, grouped=True)
    except (RuntimeError, NotImplementedError) as err:
        pytest.skip(f"torch._grouped_mm does not run on this CPU build: {err}")
    assert rel(got, moe_dropless_mlp(moe, cfg, x, grouped=False)) <= 1e-6


def test_dropless_row_does_not_depend_on_its_batch_mates():
    """The last row's output with two other sets of rows before it: the
    dropless dispatch gives the same to f32 rounding; the capacity dispatch
    at 1.25 moves it by far more (its slots are shared with the batch, and
    the last tokens are dropped first)."""
    cfg = small_cfg()
    params, _ = model_of(cfg)
    moe = params.layers[1].moe
    a, b = hidden(cfg, b=4, seed=7), hidden(cfg, b=4, seed=8)
    b[-1] = a[-1]
    assert rel(moe_dropless_mlp(moe, cfg, b)[-1], moe_dropless_mlp(moe, cfg, a)[-1]) <= 1e-6
    cap = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    assert rel(moe_capacity_mlp(moe, cap, b)[-1], moe_capacity_mlp(moe, cap, a)[-1]) > 100 * F32


def test_dropless_counts_its_rows():
    """While a profiler records: ``moe.routed`` T k a layer and
    ``moe.routed_peak`` E times the busiest expert's rows; no capacity
    counters."""
    cfg = small_cfg()
    params, _ = model_of(cfg)
    moe = params.layers[1].moe
    x = hidden(cfg)
    telemetry.clear_window_log()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        moe_mlp(moe, cfg, x)
    c = telemetry.window_log().counters
    top_e, _ = moe_select(moe, cfg, x.reshape(-1, cfg.d_model))
    peak = int(torch.bincount(top_e.reshape(-1), minlength=8).max()) * 8
    assert int(c["moe.routed"]) == 60 * 2 and int(c["moe.routed_peak"]) == peak
    assert "moe.kept" not in c and "moe.slots" not in c


# ---- the stack ---------------------------------------------------------------

def test_config_structure_and_counts():
    cfg = get_config("moonlight-16b-a3b")
    assert cfg.layer_types() == ["dense"] + ["moe"] * 26
    assert cfg.qk_head_dim == 192 and cfg.dropless and cfg.is_mla
    assert cfg.param_count() == 15_960_108_160
    small = small_cfg()
    params, _ = model_of(small)
    held = sum(p.numel() for p in params.parameters()) - small.d_model   # ln_f
    assert small.param_count() == held
    assert [type(x).__name__ for x in params.layers] == ["AttentionLayer", "MoeLayer",
                                                         "MoeLayer"]


def test_pair_scorer_matches_reference_pair_by_pair():
    """Dense-then-MoE through ``PairScorer`` (padded batches of 4, length
    buckets 16 and 32) to P(match) against the reference run on each
    prompt alone, unpadded: dropless, a pair's answer does not depend on
    its batch.  The YES / NO logits to f32 rounding of the largest; a
    bf16 model is farther off."""
    from repro_torch.serve import PairScorer

    cfg = small_cfg()
    params, w = model_of(cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(8, cfg.vocab_size, rng.integers(5, 30)) for _ in range(10)]
    scorer = PairScorer(cfg, params, lambda p: prompts[p[0]], YES, NO, max_len=32,
                        batch_size=4, device="cpu")
    got = scorer.score(np.stack([np.arange(10), np.zeros(10, np.int64)], 1))
    batches = [(torch.as_tensor(t)[None], torch.tensor([len(t) - 1])) for t in prompts]
    lg = np.concatenate(R.yes_no_logits(w, ref_model(cfg), batches, YES, NO, device="cpu"))
    want = 1.0 / (1.0 + np.exp(lg[:, 1] - lg[:, 0]))
    gap = np.abs(np.log(got / (1 - got)) - (lg[:, 0] - lg[:, 1]))
    assert gap.max() <= F32 * np.abs(lg).max() * 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    bf = small_cfg(dtype="bfloat16")
    bparams = init_params(bf, seed=0, device="cpu")
    bparams.load_state_dict({k: v.to(bparams.state_dict()[k].dtype)
                             for k, v in params.state_dict().items()})
    toks = torch.as_tensor(prompts[0])[None]
    low = forward(bf, bparams, {"tokens": toks})[0, -1, [YES, NO]].double().numpy()
    assert np.abs((low[0] - low[1]) - (lg[0, 0] - lg[0, 1])) > F32 * np.abs(lg).max() * 2


def test_tapped_routes_hold_the_choice_apart_from_the_arithmetic(monkeypatch):
    """The dropless dispatch hands its experts to ``telemetry.tapping``; the
    reference laid over them agrees with the program to f32 rounding and
    finds every choice its own (margins 0).  A router that ignores its
    bias: the arithmetic on its choice still agrees, the margins show the
    fault in a large share of choices."""
    import types

    cfg = small_cfg()
    params, w = model_of(cfg)
    toks = torch.randint(8, 264, (4, 24), generator=torch.Generator().manual_seed(9))
    last = torch.full((4,), 23)

    def run():
        with telemetry.tapping("moe.routes") as taps:
            lg = forward(cfg, params, {"tokens": toks})[:, -1, [YES, NO]]
        margins = []
        want = R.yes_no_logits(w, ref_model(cfg), [(toks, last)], YES, NO, device="cpu",
                               routes=[taps["moe.routes"]], margins=margins)[0]
        return rel(lg, want), margins[0]

    err, margins = run()
    assert err <= F32 and margins.shape == (2, 96) and margins.max() == 0
    orig = layers.moe_select
    monkeypatch.setattr(layers, "moe_select",
                        lambda p, c, x: orig(types.SimpleNamespace(router=p.router), c, x))
    err, margins = run()
    assert err <= F32 and np.mean(margins > 0.01) >= 0.2


def test_olmoe_forward_unchanged():
    """``olmoe-1b-7b``'s smoke forward (seed 3, tokens of seed 5) at f32
    and bf16 equals, bit for bit, what the tree before the MLA and dropless
    options computed, and so do its routes and capacity slots."""
    from pathlib import Path

    ref = np.load(Path(__file__).parent / "fixtures" / "olmoe_smoke_forward.npz")
    for dt in ("float32", "bfloat16"):
        cfg = get_smoke_config("olmoe-1b-7b", dtype=dt)
        params = init_params(cfg, seed=3, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)))
        routes = []
        orig = layers.moe_route

        def record(p, c, x):
            r = orig(p, c, x)
            routes.append(torch.stack([r[0], r[2].long(), r[3]]).numpy())
            return r

        layers.moe_route = record
        try:
            lg = forward(cfg, params, {"tokens": toks})
        finally:
            layers.moe_route = orig
        assert np.array_equal(np.stack(routes).astype(np.int16), ref[f"routes_{dt}"])
        assert np.array_equal(lg.float().numpy(), ref[f"logits_{dt}"])


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grouped_products_on_card(card):
    """``torch._grouped_mm`` over device offsets against one product an
    expert, bf16 at the published expert widths (2,048 x 1,408), with empty
    experts among them."""
    from repro_torch.models.layers import expert_matmul

    g = torch.Generator(device=card).manual_seed(0)
    counts = torch.tensor([300, 0, 17, 1, 0, 811, 64, 2], device=card)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    x = torch.randn(int(counts.sum()), 2048, generator=g, device=card).bfloat16()
    w = (torch.randn(8, 2048, 1408, generator=g, device=card) * 2048**-0.5).bfloat16()
    got = expert_matmul(x, w, counts, offs, grouped=True)
    want = expert_matmul(x, w, counts, offs, grouped=False)
    torch.cuda.synchronize()
    assert rel(got.float(), want.float()) <= 2**-8


@pytest.mark.cuda
def test_three_layers_at_published_widths_on_card(card):
    """Moonlight cut to 3 layers (dense, MoE, MoE) at its published widths,
    bf16 on the card through K5 at (192, 128) and the grouped dropless
    dispatch, against the f32 reference on the card laid over the experts
    the card chose (``tests/ref_moonlight.py``'s forced routes: a near tie
    that bf16 rounding breaks the other way moves a token by a whole
    expert, which is the choice's fault and not the arithmetic's).  The
    YES - NO logit of 64 prompts of 48 tokens within 0.25 (bf16 rounding
    through 3 layers: ~0.02 typical), and the card's experts short of the
    reference's own top 6 by more than 0.01 in score + bias in no more
    than 1 in 1,000 of the (token, layer) choices (near ties; a router
    without its bias misses in about half)."""
    from repro_torch.kernels import cuda_lib

    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"), num_layers=3)
    params = init_params(cfg, seed=1, device=card)
    g = torch.Generator(device=card).manual_seed(2)
    w = {}
    for name, p in params.named_parameters():
        if name.endswith("router_bias"):
            p.copy_(torch.randn(p.shape, generator=g, device=card) * 0.02)
        w[name] = p.detach()
    toks = torch.randint(8, 264, (64, 48), generator=g, device=card)
    cuda_lib.reset_launches()
    with telemetry.tapping("moe.routes") as taps:
        lg = forward(cfg, params, {"tokens": toks})[:, -1, [YES, NO]].double()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention_192_128"] == 3
    assert len(taps["moe.routes"]) == 2
    last = torch.full((64,), 47, device=card)
    margins = []
    want = R.yes_no_logits(w, ref_model(cfg), [(toks, last)], YES, NO, device=card,
                           routes=[taps["moe.routes"]], margins=margins)[0]
    gap = np.abs((lg[:, 0] - lg[:, 1]).cpu().numpy() - (want[:, 0] - want[:, 1]))
    assert gap.max() <= 0.25, gap
    assert np.mean(margins[0] > 0.01) <= 1e-3
