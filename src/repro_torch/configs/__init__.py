"""Architecture config registry: the 10 assigned architectures + the paper's
own small Oracle/embedder models, as in the reference's ``repro.configs``,
and Moonlight-16B-A3B, which only the port runs (so it is not in ``ARCHS``,
which tests walk against the reference's configs).
``get_config(name)`` returns the full config; ``get_smoke_config(name)`` the
reduced CPU-testable variant.  The embedder module also carries the
precision table of the similarity kernels.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig, reduced

ARCHS = [
    "qwen2-1.5b",
    "mistral-nemo-12b",
    "llama3.2-1b",
    "llama3-8b",
    "olmoe-1b-7b",
    "qwen3-moe-235b-a22b",
    "whisper-medium",
    "rwkv6-1.6b",
    "pixtral-12b",
    "recurrentgemma-9b",
]

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3.2-1b": "llama3_2_1b",
    "llama3-8b": "llama3_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-medium": "whisper_medium",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "pixtral-12b": "pixtral_12b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
    "joinml-oracle": "joinml_oracle",
    "joinml-embedder": "joinml_embedder",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)
