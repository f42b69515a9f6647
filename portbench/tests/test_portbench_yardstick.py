"""The frozen yardsticks held to hand-worked values at small shapes."""
import pytest

from harness import yardstick as ys

TINY = dict(num_layers=1, d_model=4, head_dim=2, num_heads=2, num_kv_heads=1, d_ff=3,
            num_experts=4, num_experts_per_tok=2, vocab_size=10)


def test_peaks():
    assert ys.PEAK_FLOPS_F32 == 67e12 and ys.PEAK_FLOPS_BF16 == 989e12
    assert ys.HBM_BW == 3.35e12


def test_sweep_work_by_hand():
    ops, byts, peak = ys.sim_sweep(512, 256, 8, "fp32", k=4, bm=256, n_bins=16)
    assert ops == 2 * 512 * 256 * 8
    # rows read once, row scales and column vector, 2 count tiles, top-4
    # (value, index) a row, a walk sum a row
    assert byts == 768 * 8 * 4 + 768 * 4 + 2 * 16 * 4 + 512 * 4 * 8 + 512 * 4
    assert peak == 67e12
    assert ys.sim_sweep(512, 256, 8, "bf16", k=4, bm=256, n_bins=16)[1] == byts - 768 * 8 * 2


def test_sweep_bound_at_the_cell_shape():
    ops, byts, peak = ys.sim_sweep(262144, 262144, 384)
    assert ys.bound_s(ops, byts, peak) == pytest.approx(2 * 262144**2 * 384 / 67e12)
    assert ys.bound_s(1.0, 3.35e12, 67e12) == 1.0


def test_model_work_by_hand():
    # attention: 4*2*(2 + 2*1) + 2*2*4 = 48; router 4*4, two experts 2*3*4*3 = 72
    assert ys.token_flops(TINY) == 2 * (48 + 16 + 72)
    assert ys.token_flops(dict(TINY, num_experts=0)) == 2 * (48 + 3 * 4 * 3)
    # a 3-token prompt: 1 + 2 + 3 keys, 4 ops a key and head dim, 2 heads
    assert ys.attention_flops(TINY, 3) == 4 * 2 * 2 * 6
    assert ys.head_flops(TINY) == 2 * 4 * 10
    assert ys.pair_flops(TINY, 3) == 3 * 272 + 96 + 80


def test_olmoe_token_flops():
    olmoe = dict(num_layers=16, d_model=2048, head_dim=128, num_heads=16, num_kv_heads=16,
                 d_ff=1024, num_experts=64, num_experts_per_tok=8, vocab_size=50304)
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert ys.token_flops(olmoe) == 2 * 16 * per_layer   # 2.15 GFLOP a token
    assert ys.head_flops(olmoe) == 2 * 2048 * 50304


def test_the_copies_agree_with_the_port_today():
    from repro_torch.roofline import hw, kernel_work

    assert (hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_BF16, hw.HBM_BW) == (
        ys.PEAK_FLOPS_F32, ys.PEAK_FLOPS_BF16, ys.HBM_BW)
    assert kernel_work.sim_sweep(262144, 262144, 384) == ys.sim_sweep(262144, 262144, 384)
