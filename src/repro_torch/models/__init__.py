"""The Oracle model stack on PyTorch: configs, layers, the dense / RWKV6 /
RecurrentGemma-hybrid models, with K5-K7 behind attention and the scans."""
from .config import ModelConfig, reduced  # noqa: F401
from .model import (  # noqa: F401
    Model,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
