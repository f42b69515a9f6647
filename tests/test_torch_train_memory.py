"""The train step's AdamW update in place (``optimizer.adamw_update_``): a
large leaf updated ``CHUNK`` elements of whole rows at a time gives the
same bits as the whole leaf at once (``adamw_update``, the same update on
copies), with each leaf's gradient taken out of the gradients and its new
moments put in the state as it goes, so that a step never holds two sets
of moments (what lets the 3.88 B parameters of recurrentgemma-9b cut to 8
layers train on one 80 GB card)."""
import numpy as np
import pytest
import torch

from repro_torch.train import optimizer
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    adamw_update_,
    compress_grads,
    init_opt_state,
)


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (40, 8), "layers.0.w": (8, 8), "layers.0.norm": (8,), "bias": (8,)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("chunk", [optimizer.CHUNK, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_in_place_update_equals_functional_bit_for_bit(dtype, mode, chunk, monkeypatch):
    """Three steps, the state carried across; the functional update at the
    default chunk (whole leaves here) leaves its inputs as they were; with a
    chunk of 16 elements the in-place update takes the (40, 8) leaf 2 rows
    at a time."""
    cfg = OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10, clip_norm=2.0,
                          grad_compression=mode)
    ref = _tree(0, dtype)
    got = {k: torch.nn.Parameter(v.clone(), requires_grad=False) for k, v in ref.items()}
    ref_state, state = init_opt_state(ref), init_opt_state(got)
    m_dict = state["m"]
    for step in range(3):
        grads = {k: v * (3.0 if step == 1 else 0.5) for k, v in _tree(10 + step, dtype).items()}
        ref_grads = compress_grads(dict(grads), mode)
        before = [{k: t.clone() for k, t in d.items()}
                  for d in (ref, ref_state["m"], ref_state["v"], ref_grads)]
        new, new_state, ref_stats = adamw_update(ref, ref_grads, ref_state, cfg)
        for d, was in zip((ref, ref_state["m"], ref_state["v"], ref_grads), before):
            assert d.keys() == was.keys() and all(torch.equal(d[k], was[k]) for k in d)
        ref, ref_state = new, new_state
        consumed = compress_grads(dict(grads), mode)
        with monkeypatch.context() as mp:
            mp.setattr(optimizer, "CHUNK", chunk)
            stats = adamw_update_(got, consumed, state, cfg)
        assert consumed == {}  # every gradient left as its leaf was updated
        assert state["m"] is m_dict  # the state's dicts, updated in place
        assert torch.equal(stats["lr"], ref_stats["lr"])
        assert torch.equal(stats["grad_norm"], ref_stats["grad_norm"])
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        for k in ref:
            assert got[k].dtype == dtype and torch.equal(got[k], ref[k]), k
            assert torch.equal(state["m"][k], ref_state["m"][k]), k
            assert torch.equal(state["v"][k], ref_state["v"][k]), k
