"""The Moonlight cell (``moonlight-names.count-b2k``, Oracle kind
``mla_moe``) in its CPU rehearsal: the unbroken path reads ``correct``
(its replayed batches equal the window's bit for bit), and a program that
routes without the correction bias, with half of it or its negation,
with its router's product in bf16, or that leaves the shared expert out,
does not.  The planted faults break the program's side alone (the
reference reads the same weights).  Also: the parent's
kind of program, one whose ``ModelConfig`` lacks the new fields, is
refused at set-up, and the frozen operation counts match the port's own
parameter counts."""
import io
import json
import types
from contextlib import redirect_stdout

import pytest
import torch

import run
from harness import spec

CELL = "moonlight-names.count-b2k"


def _line(seed=77):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                       "--rehearse-cpu"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def bias_ignored(monkeypatch):
    """The router chooses its experts by the sigmoid scores alone."""
    from repro_torch.models import layers

    orig = layers.moe_select

    def broken(p, cfg, xt):
        return orig(types.SimpleNamespace(router=p.router), cfg, xt)

    monkeypatch.setattr(layers, "moe_select", broken)


def _scaled_bias(monkeypatch, scale):
    from repro_torch.models import layers

    orig = layers.moe_select

    def broken(p, cfg, xt):
        return orig(types.SimpleNamespace(router=p.router, router_bias=scale * p.router_bias),
                    cfg, xt)

    monkeypatch.setattr(layers, "moe_select", broken)


def bias_halved(monkeypatch):
    """The router chooses by the scores plus half the correction bias."""
    _scaled_bias(monkeypatch, 0.5)


def bias_negated(monkeypatch):
    """The router chooses by the scores less the correction bias."""
    _scaled_bias(monkeypatch, -1.0)


def router_in_bf16(monkeypatch):
    """The router's product in bf16 (its input, weight and output rounded),
    where the configuration's router is f32; the rest as ``moe_select``."""
    from repro_torch.models import layers

    def broken(p, cfg, xt):
        scores = torch.sigmoid((xt.bfloat16() @ p.router.bfloat16()).float())
        top_e = torch.topk(scores + p.router_bias, cfg.num_experts_per_tok, dim=-1).indices
        top_w = scores.gather(-1, top_e)
        return top_e, top_w / top_w.sum(-1, keepdim=True) * cfg.routed_scaling_factor

    monkeypatch.setattr(layers, "moe_select", broken)


def shared_left_out(monkeypatch):
    """The MoE layers return the routed experts' sum without the shared
    expert."""
    from repro_torch.models import layers, model

    monkeypatch.setattr(model, "moe_mlp", layers.moe_dropless_mlp)


def test_the_unbroken_path_is_correct():
    line = _line()
    assert line["correct"] is True
    assert line["checks"]["replay_gap"]["value"] == 0
    assert line["checks"]["router_gap"]["value"] == 0


@pytest.mark.parametrize("fault,number", [(bias_ignored, "route_miss"),
                                          (bias_halved, "router_gap"),
                                          (bias_negated, "router_gap"),
                                          (router_in_bf16, "router_gap"),
                                          (shared_left_out, "far_share")])
@pytest.mark.parametrize("seed", [77, 4294967311])
def test_a_broken_model_is_not_correct(monkeypatch, fault, number, seed):
    """A router's fault shows in the choice of experts (the arithmetic on
    the experts it chose is right): against the reference's own hidden
    state, or, finer, against the reference router on the program's own
    router input (a bf16 product falls short by ~1e-3 there, inside the
    bf16 forward's own near ties); the missing shared expert in the
    answers."""
    fault(monkeypatch)
    line = _line(seed)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]


def test_a_program_without_the_fields_is_refused():
    """The kind hands the model keys over unfiltered: a ``ModelConfig``
    without latent attention raises instead of serving another model."""
    import dataclasses

    from harness.spec import load_module
    from repro_torch.models.config import ModelConfig

    kind = load_module("oracles", "mla_moe")
    cell = spec.load_cell(CELL)
    old = {f.name for f in dataclasses.fields(ModelConfig)} - {
        "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "moe_d_ff", "shared_experts", "first_dense_layers", "router", "router_bias",
        "norm_topk_prob", "routed_scaling_factor"}
    Old = dataclasses.make_dataclass("ModelConfig", [(n, object) for n in sorted(old)])
    with pytest.raises(TypeError):
        Old(**cell.config["model"])
    cfg = kind.model_config(cell.config["model"])
    assert cfg.is_mla and cfg.dropless and cfg.layer_types().count("moe") == 26


def test_frozen_counts_follow_the_model():
    """The kind's per-token operations equal twice the port's active
    parameters a token touches, less the embedding, the head, the layers'
    norms and the router biases (which it counts apart or not at all; the
    port's count leaves the final norm out)."""
    from harness.spec import load_module

    kind = load_module("oracles", "mla_moe")
    m = spec.load_cell(CELL).config["model"]
    cfg = kind.model_config(m)
    d, layers = cfg.d_model, cfg.num_layers
    norms = 2 * d * layers + cfg.kv_lora_rank * layers
    biases = cfg.num_experts * (layers - cfg.first_dense_layers)
    matrices = cfg.active_param_count() - 2 * cfg.vocab_size * d - norms - biases
    assert kind.token_flops(m) == 2.0 * matrices
    assert kind.head_flops(m) == 2.0 * d * cfg.vocab_size
