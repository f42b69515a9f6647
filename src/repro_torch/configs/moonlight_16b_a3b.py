"""Moonlight-16B-A3B [arXiv:2502.16982; config huggingface.co/moonshotai/
Moonlight-16B-A3B]: DeepSeek-V3's blocks [arXiv:2412.19437].  27 layers,
the first a dense SwiGLU of 11,264, the rest MoE: 64 routed experts of
1,408, 6 a token, chosen by sigmoid scores plus a correction bias
(noaux_tc, one group), their weights renormalised and scaled by 2.446, and
2 shared experts as one SwiGLU of 2,816.  Latent attention without a q
LoRA: 16 heads, a 512-wide KV latent, q and k 128 + 64 (RoPE) wide, v
128; RoPE theta 50,000 over the 64 rope dims, paired interleaved (dims
2i and 2i + 1) as DeepSeek-V3's published code pairs them.  Served
dropless (``moe_capacity_factor`` 0)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=11264, vocab_size=163840, rope_theta=50_000.0, norm_eps=1e-5,
    kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64, num_experts_per_tok=6, moe_capacity_factor=0.0, moe_d_ff=1408,
    shared_experts=2, first_dense_layers=1, router="sigmoid", router_bias=True,
    norm_topk_prob=True, routed_scaling_factor=2.446, act="silu",
)
