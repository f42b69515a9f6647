"""The port's trainer (``repro_torch.train``, ``models.loss_fn``) against
the reference's (``repro.train``, ``repro.models.loss_fn``) on the CPU.

Parameters and optimizer state are carried across with
``interop.params_from_jax`` / ``opt_state_from_jax``; the reference's
gradients come back through ``params_from_jax`` too, so the two are held
parameter by parameter.  Tolerances:

* the optimizer's functions on one f32 tree fed the same gradients: 1e-6
  relative to each leaf's largest |x| (the same f32 operations in the same
  order, but XLA may contract ``a * x + b * y`` into an fma, which moves
  an element whose two terms cancel by an ulp of the terms);
* loss and gradients of every ``ARCHS`` entry at the smoke config in f32:
  within 1e-4 of each leaf's largest |g| (two f32 evaluations of the same
  function whose sums run in other orders; the forward alone agrees
  within 2e-5 of the logits, ``tests/test_torch_models.py``);
* the parameter update of a train step within the same rule, at ``eps =
  1``: Adam's first step is ``lr * sign(g)`` wherever |g| >> eps, which
  turns f32 noise in a gradient near 0 into a full step of either sign;
  at ``eps = 1`` the step is a smooth function of g, so the gradients'
  rule carries over;
* bf16: the forward's 6e-2 rule, relative to the largest |g| of a leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro.models.model as RM
import repro.train as RT
import repro_torch.models.layers as PL
import repro_torch.models.model as PMM
import repro_torch.train as PT
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.checkpoint.checkpoint import restore_latest, save
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.models import init_params
from repro_torch.runtime.fault_tolerance import DeterministicSkipper

REL = 1e-6
GRAD_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
# reduced configs as tests/test_torch_models.py sizes them: recurrentgemma
# at 5 layers runs one pattern block and the 2-layer tail
OVER = {"recurrentgemma-9b": {"num_layers": 5}}
B, S = 2, 12


def _batch(cfg, seed, b=B, s=S, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pair(arch, dtype="float32", **over):
    over = dict(OVER.get(arch, {}), dtype=dtype, **over)
    rcfg = jax_smoke_config(arch, **over)
    rparams = jax_init_params(rcfg, jax.random.key(3))
    cfg = get_smoke_config(arch, **over)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rparams, cfg, params


def _hold_leaves(got: dict, want: dict, tol: float, what: str):
    """Each leaf of ``got`` within ``tol`` of the largest |x| of the same
    leaf of ``want`` (exact where that leaf is 0)."""
    assert set(got) == set(want), what
    for name in want:
        w, g = _np(want[name]), _np(got[name])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {name}")


# ----------------------------------------------------------------------------
# the optimizer's functions on one tree
# ----------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg = dict(peak_lr=3e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    rc, pc = RT.OptimizerConfig(**cfg), PT.OptimizerConfig(**cfg)
    steps = np.arange(0, 131)
    want = np.array([float(RT.lr_schedule(jnp.int32(s), rc)) for s in steps])
    got = np.array([float(PT.lr_schedule(torch.tensor(s, dtype=torch.int32), pc))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "e": rng.standard_normal((5, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_adamw_clip_and_compression_match_reference(mode):
    """Three AdamW steps on one tree, the state carried across, with the
    gradients compressed first: params, moments, lr and grad norm within
    1e-6 relative."""
    kw = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=10, clip_norm=2.0,
              grad_compression=mode)
    rc, pc = RT.OptimizerConfig(**kw), PT.OptimizerConfig(**kw)
    rp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    pp = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    ro, po = RT.init_opt_state(rp), PT.init_opt_state(pp)
    for step in range(3):
        g = {k: v * (3.0 if step == 1 else 0.5) for k, v in _tree(10 + step).items()}
        rg = RT.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, mode)
        pg = PT.compress_grads({k: torch.from_numpy(v) for k, v in g.items()}, mode)
        _hold_leaves(pg, rg, REL, f"{mode} compressed")
        rclip, rn = RT.clip_by_global_norm(rg, rc.clip_norm)
        pclip, pn = PT.clip_by_global_norm(pg, pc.clip_norm)
        np.testing.assert_allclose(float(pn), float(rn), rtol=REL)
        _hold_leaves(pclip, rclip, REL, "clipped")
        rp, ro, rs = RT.adamw_update(rp, rg, ro, rc)
        pp, po, ps = PT.adamw_update(pp, pg, po, pc)
        assert int(po["step"]) == int(ro["step"]) == step + 1
        np.testing.assert_allclose(float(ps["lr"]), float(rs["lr"]), rtol=REL)
        np.testing.assert_allclose(float(ps["grad_norm"]), float(rs["grad_norm"]), rtol=REL)
        _hold_leaves(pp, rp, REL, "params")
        _hold_leaves(po["m"], ro["m"], REL, "m")
        _hold_leaves(po["v"], ro["v"], REL, "v")


# ----------------------------------------------------------------------------
# loss, gradients and one train step of every architecture
# ----------------------------------------------------------------------------

def test_port_archs_are_the_references():
    assert list(ARCHS) == list(JAX_ARCHS)


@pytest.mark.parametrize("arch", ARCHS + ["joinml-oracle"])
def test_train_step_matches_reference(arch):
    """loss_fn's value and gradients, then one train step (the state
    carried across) at f32: within 1e-4 of each leaf's largest |g| or
    |update|."""
    rcfg, rparams, cfg, params = _pair(arch)
    batch = _batch(cfg, 1, mask=arch == "joinml-oracle")
    rloss, rgrads = jax.jit(jax.value_and_grad(lambda p: RM.loss_fn(rcfg, p, _jnp(batch))))(rparams)
    loss, grads = PT.loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray, rgrads), device="cpu")
                .named_parameters())
    _hold_leaves(grads, want, GRAD_TOL["float32"], f"{arch} gradient")

    kw = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=10, eps=1.0)
    rstate = RT.init_opt_state(rparams)
    state = opt_state_from_jax(cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    # the reference's train step at one microbatch, from the gradients above
    rnew, _, rm = RT.adamw_update(rparams, rgrads, rstate, RT.OptimizerConfig(**kw))
    params, state, m = PT.make_train_step(cfg, PT.OptimizerConfig(**kw))(params, state, batch)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    ref_new = dict(params_from_jax(cfg, jax.tree.map(np.asarray, rnew), device="cpu")
                   .named_parameters())
    _hold_leaves({k: p - before[k] for k, p in params.named_parameters()},
                 {k: p - before[k] for k, p in ref_new.items()},
                 GRAD_TOL["float32"], f"{arch} update")
    assert int(state["step"]) == 1


def test_train_step_bf16_matches_reference():
    """joinml-oracle at bf16 under the forward's 6e-2 rule."""
    rcfg, rparams, cfg, params = _pair("joinml-oracle", dtype="bfloat16")
    batch = _batch(cfg, 2, mask=True)
    rloss, rgrads = jax.jit(jax.value_and_grad(lambda p: RM.loss_fn(rcfg, p, _jnp(batch))))(rparams)
    loss, grads = PT.loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=GRAD_TOL["bfloat16"])
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray, rgrads), device="cpu")
                .named_parameters())
    assert all(g.dtype == want[k].dtype for k, g in grads.items())
    _hold_leaves(grads, want, GRAD_TOL["bfloat16"], "bf16 gradient")


# ----------------------------------------------------------------------------
# the dtype barriers, remat, microbatches
# ----------------------------------------------------------------------------

def test_ce_bf16_value_and_cotangent_type():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    rl = jnp.asarray(logits, jnp.bfloat16)
    rv, rvjp = jax.vjp(lambda x: RM._ce_bf16(x, jnp.asarray(targets), jnp.bfloat16), rl)
    (rg,) = rvjp(jnp.ones_like(rv))
    pl = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    pv = PMM._ce_bf16(pl, torch.from_numpy(targets).long())
    (pg,) = torch.autograd.grad(pv.sum(), pl)
    np.testing.assert_allclose(_np(pv), np.asarray(rv, np.float32), rtol=1e-6)
    assert pg.dtype == torch.bfloat16 and rg.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(pg), np.asarray(rg, np.float32), rtol=0, atol=2**-8)


def test_grad_cast_is_identity_with_cast_cotangent():
    """Identity forward; the cotangent is rounded to the barrier's type.
    JAX hands that bf16 cotangent on; torch's autograd gives a tensor's
    gradient its own type, so an f32 input receives the bf16-rounded values
    in f32 (in the model the barrier sits on bf16 q, k, v, where both are
    bf16)."""
    x = np.linspace(-1, 1, 6, dtype=np.float32)
    g = (np.pi * np.arange(1, 7)).astype(np.float32)
    rv, rvjp = jax.vjp(lambda t: RL.grad_cast(t, jnp.bfloat16), jnp.asarray(x))
    (rg,) = rvjp(jnp.asarray(g))
    px = torch.from_numpy(x).requires_grad_()
    pv = PL.grad_cast(px, torch.bfloat16)
    (pg,) = torch.autograd.grad(pv, px, torch.from_numpy(g))
    assert torch.equal(pv.detach(), px.detach())
    np.testing.assert_array_equal(np.asarray(rv), x)
    assert rg.dtype == jnp.bfloat16 and pg.dtype == torch.float32
    np.testing.assert_array_equal(_np(pg), np.asarray(rg, np.float32))
    assert not np.array_equal(_np(pg), g)          # the rounding happened
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    (gb,) = torch.autograd.grad(PL.grad_cast(xb, torch.bfloat16).float(), xb,
                                torch.from_numpy(g))
    assert gb.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["joinml-oracle", "whisper-medium"])
def test_remat_settings_give_equal_gradients(arch):
    """Remat off, on, and on with the "dots" policy: the same gradients."""
    cfg = get_smoke_config(arch, dtype="float32", bf16_backward=True)
    params = init_params(cfg, 0, device="cpu")
    batch = _batch(cfg, 3)
    out = []
    for over in ({"remat": False}, {"remat": True}, {"remat": True, "remat_policy": "dots"}):
        c = dataclasses.replace(cfg, **over)
        params.cfg = c
        for layer in params.modules():
            if hasattr(layer, "cfg"):
                layer.cfg = c
        out.append(PT.loss_and_grads(c, params, batch))
    for loss, grads in out[1:]:
        assert float(loss) == float(out[0][0])
        for k, g in grads.items():
            torch.testing.assert_close(g, out[0][1][k], rtol=0, atol=0)


def test_microbatch_equivalence():
    """4 microbatches against 1 (the reference's tolerances,
    tests/test_substrates.py), and the port's 4 against the reference's 4."""
    rcfg, rparams, cfg, params = _pair("llama3.2-1b")
    batch = _batch(cfg, 4, b=4, s=16)
    kw = dict(peak_lr=0.0, warmup_steps=0, weight_decay=0.0)
    state = PT.init_opt_state(params)
    m = {}
    for n in (1, 4):
        before = {k: p.detach().clone() for k, p in params.named_parameters()}
        _, _, m[n] = PT.make_train_step(cfg, PT.OptimizerConfig(**kw), n)(params, state, batch)
        for k, p in params.named_parameters():   # lr 0: nothing moves
            assert torch.equal(p, before[k])
    assert float(m[1]["loss"]) == pytest.approx(float(m[4]["loss"]), rel=2e-2)
    assert float(m[1]["grad_norm"]) == pytest.approx(float(m[4]["grad_norm"]), rel=3e-2)
    _, _, r4 = jax.jit(RT.make_train_step(rcfg, RT.OptimizerConfig(**kw), 4))(
        rparams, RT.init_opt_state(rparams), _jnp(batch))
    np.testing.assert_allclose(float(m[4]["loss"]), float(r4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m[4]["grad_norm"]), float(r4["grad_norm"]), rtol=1e-4)


def test_train_restart_resumes_identically(tmp_path):
    """3 steps, save, restore, 3 more == 6 uninterrupted steps, bit for bit
    on the CPU (the reference's test_substrates case, held exact)."""
    cfg = get_smoke_config("llama3.2-1b", remat=False, num_layers=1, d_model=32,
                           num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                           vocab_size=64, dtype="float32")
    step_fn = PT.make_train_step(cfg, PT.OptimizerConfig(peak_lr=1e-3, warmup_steps=0))
    skipper = DeterministicSkipper(seed=42)

    def batch_at(s):
        return {"tokens": skipper.batch_rng(s).integers(0, 64, (2, 12))}

    p = init_params(cfg, 1, device="cpu")
    o = PT.init_opt_state(p)
    for s in range(6):
        p, o, _ = step_fn(p, o, batch_at(s))

    p2 = init_params(cfg, 1, device="cpu")
    o2 = PT.init_opt_state(p2)
    for s in range(3):
        p2, o2, _ = step_fn(p2, o2, batch_at(s))
    save(str(tmp_path), 3, {"params": p2, "opt": o2})
    p3 = init_params(cfg, 99, device="cpu")
    restored, manifest = restore_latest(str(tmp_path), {"params": p3, "opt": PT.init_opt_state(p3)})
    assert manifest["step"] == 3
    p3, o3 = restored["params"], restored["opt"]
    for s in range(3, 6):
        p3, o3, _ = step_fn(p3, o3, batch_at(s))
    for (k, a), b in zip(p.named_parameters(), p3.parameters()):
        assert torch.equal(a, b), k
    for k in o["m"]:
        assert torch.equal(o["m"][k], o3["m"][k]) and torch.equal(o["v"][k], o3["v"][k])
    assert int(o3["step"]) == 6


@pytest.mark.slow
def test_train_loop_loss_decreases():
    """The reference's learnability check on the port: 60 steps of a tiny
    Oracle on a synthetic pair corpus."""
    from repro_torch.data.pipeline import ByteTokenizer, make_entity_corpus, make_pair_batch

    tok = ByteTokenizer()
    cfg = get_smoke_config("qwen2-1.5b", vocab_size=tok.vocab_size, remat=False)
    params = init_params(cfg, 0, device="cpu")
    opt = PT.init_opt_state(params)
    step_fn = PT.make_train_step(cfg, PT.OptimizerConfig(peak_lr=3e-3, warmup_steps=5,
                                                         decay_steps=80))
    records, ids = make_entity_corpus(16, 3, noise=0.05, seed=0)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(60):
        batch = make_pair_batch(tok, records, ids, batch=8, max_len=48, rng=rng)
        params, opt, m = step_fn(params, opt,
                                 {"tokens": batch["tokens"], "loss_mask": batch["loss_mask"]})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8
    assert np.isfinite(losses).all()
