"""The Oracle model stack on PyTorch: configs, layers, and every family of
the reference (dense, MoE, VLM, RWKV6, the RecurrentGemma hybrid, the
Whisper encoder-decoder), with K5-K7 behind attention and the scans."""
from .config import ModelConfig, reduced  # noqa: F401
from .model import (  # noqa: F401
    Model,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
