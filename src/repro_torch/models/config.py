"""Model configuration for the Oracle/embedder substrate.

A copy of the reference's ``models/config.py``: the port imports nothing of
the reference.  One config per assigned architecture (see
``repro_torch.configs``); reduced configs drive the CPU tests, full configs
run on the card (``chip_smoke.py``).  Fields of levers the port does not
run yet (remat, the bf16 backward: training is ROADMAP queue 1, item 11)
are kept so that a config means the same thing in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                 # >0: sliding-window (local) attention
    causal: bool = True

    # latent attention (MLA, DeepSeek-V2/V3): on when kv_lora_rank > 0; q
    # and k are qk_nope_head_dim + qk_rope_head_dim wide, v v_head_dim
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # q's LoRA: only 0 (q a plain projection) is built
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25   # 0 -> dropless
    moe_d_ff: int = 0               # an expert's width (0 -> d_ff)
    shared_experts: int = 0         # one SwiGLU of shared_experts * moe_d_ff every token passes
    first_dense_layers: int = 0     # leading layers with a dense MLP of d_ff
    router: str = "softmax"         # softmax | sigmoid
    router_bias: bool = False       # a correction bias added for selection only (noaux_tc)
    norm_topk_prob: bool = True     # the top-k weights renormalised to sum 1
    routed_scaling_factor: float = 1.0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500         # precomputed audio frames (stub frontend)

    # hybrid (recurrentgemma): layer pattern, e.g. ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0              # RG-LRU width (0 -> d_model)
    conv_width: int = 4

    # vlm (pixtral): number of precomputed patch embeddings per sample
    num_patches: int = 0

    # ssm (rwkv6)
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # misc
    norm_eps: float = 1e-5
    act: str = "silu"               # mlp activation: silu -> SwiGLU, gelu -> GeGLU/MLP
    tied_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True              # activation checkpointing on the layer scan
    attn_q_chunk: int = 512         # q-block size for chunked (flash-style) attention
    scan_layers: bool = True
    # §Perf levers (defaults = paper-faithful straightforward baseline):
    bf16_backward: bool = False     # gradient dtype barriers at the CE and at
                                    # the attention f32-softmax boundary, so
                                    # the whole backward runs in bf16 instead
                                    # of f32 (halves dgrad bytes/collectives)
    remat_policy: str = "full"      # "full" | "dots" (save matmul outputs)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.router not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown router {self.router!r}")
        if self.q_lora_rank:
            raise ValueError("latent attention with a q LoRA is not built: q_lora_rank 0 only")

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """Width of a q and a k head: MLA's nope + rope, else head_dim."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim if self.is_mla else self.head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def dropless(self) -> bool:
        return self.moe_capacity_factor == 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_positional_cache(self) -> bool:
        """Decode cache addressed by absolute position (full per-position KV
        rows), so a serving slot can be rewound to position 0 for mid-flight
        admission.  Recurrent state (ssm) and the hybrid ring buffer are not
        rewindable — their batchers must gate admission instead."""
        return self.family not in ("ssm", "hybrid")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> can run the long_500k cell."""
        return self.family in ("ssm", "hybrid")

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.family == "hybrid" and self.block_pattern:
            return self.block_pattern
        if self.family == "moe":
            return ("moe",)
        if self.family == "ssm":
            return ("rwkv",)
        return ("dense",)

    def layer_types(self) -> list:
        """Concrete per-layer block types of the decoder stack: an MoE's
        ``first_dense_layers`` are ``dense``."""
        pat = self.pattern
        return ["dense" if i < self.first_dense_layers else pat[i % len(pat)]
                for i in range(self.num_layers)]

    def attention_param_count(self) -> int:
        d, hd, nq, nkv = self.d_model, self.head_dim, self.num_heads, self.num_kv_heads
        if not self.is_mla:
            return d * hd * (nq + 2 * nkv) + nq * hd * d
        q = d * nq * self.qk_head_dim
        kv = (d * (self.kv_lora_rank + self.qk_rope_head_dim) + self.kv_lora_rank
              + self.kv_lora_rank * nq * (self.qk_nope_head_dim + self.v_head_dim))
        return q + kv + nq * self.v_head_dim * d

    def moe_param_count(self) -> int:
        """One MoE block: the router (and its bias), the experts and the
        shared expert."""
        d, e, ff = self.d_model, self.num_experts, self.expert_d_ff
        return (e * 3 * d * ff + d * e + (e if self.router_bias else 0)
                + 3 * d * ff * self.shared_experts)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6ND)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        attn = self.attention_param_count()
        dense_mlp = 3 * d * ff if self.act == "silu" or self.act == "geglu" else 2 * d * ff
        total = 0
        for t in self.layer_types():
            if t == "dense":
                total += attn + dense_mlp + 2 * d
            elif t == "moe":
                total += attn + self.moe_param_count() + 2 * d
            elif t == "attn":  # hybrid local-attention block
                total += attn + 3 * d * ff + 2 * d
            elif t == "rec":   # RG-LRU block
                r = self.rnn_width
                total += 2 * d * r + r * self.conv_width + 2 * r * r + 2 * r + r * d
                total += 3 * d * ff + 2 * d
            elif t == "rwkv":
                total += 6 * d * d + 2 * d * self.rwkv_decay_lora * 0 + d * self.rwkv_decay_lora + self.rwkv_decay_lora * d
                total += d * ff + ff * d + d * d + 2 * d  # channel mix
        total += v * d * (1 if self.tied_embeddings else 2)
        if self.family == "encdec":
            enc_layer = attn + 2 * d * ff + 2 * d
            total += self.encoder_layers * enc_layer
            total += self.num_layers * (attn + d)  # decoder cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        inactive = (self.num_experts - self.num_experts_per_tok) * 3 * self.d_model * self.expert_d_ff
        return int(self.param_count() - self.layer_types().count("moe") * inactive)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving the family topology."""
    small = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.block_pattern else len(cfg.pattern)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2) if cfg.num_experts else 0,
        # dropless at smoke scale so decode-vs-forward consistency holds
        moe_capacity_factor=8.0 if cfg.num_experts else cfg.moe_capacity_factor,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=32 if cfg.family == "encdec" else cfg.encoder_seq,
        rnn_width=64 if cfg.family == "hybrid" else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        num_patches=8 if cfg.num_patches else 0,
        rwkv_head_dim=16,
        rwkv_decay_lora=8,
        attn_q_chunk=16,
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
