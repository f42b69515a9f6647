"""Model assembly: dense decoder LMs, RWKV6 and RecurrentGemma-style hybrids
(the reference's ``models/model.py``), with the reference's interface:

    init_params(cfg, seed, device)                 -> Model (the parameters)
    forward(cfg, params, batch)                    -> logits        (prefill)
    init_cache(cfg, batch, max_len, device)        -> cache         (dense)
    decode_step(cfg, params, cache, tokens, pos)   -> (logits, cache)
    prefill(cfg, params, batch, max_len)           -> (logits, cache)

``batch`` is a dict ``{"tokens": (B, S)}``.  The parameters are a
:class:`Model`: one ``nn.Module`` per layer in an ``nn.ModuleList``
(``layers`` for the dense and ssm families; ``blocks`` of the hybrid
pattern and a ``tail``), named after the reference tree's keys, so
``repro_torch.interop.params_from_jax`` is a name map that unstacks the
reference's scanned axes.  The reference's activation-sharding annotations
are dropped: they do nothing on one card.

Not ported yet: the ``moe``, ``encdec`` and ``vlm`` families (ROADMAP
queue 1, items 10.1 and 10.2), decode for ``ssm`` and ``hybrid`` (item
10.3), and the loss and training (item 11).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    chunked_attention,
    decode_attention,
    dense_init,
    dtype_of,
    full,
    mlp,
    param,
    rms_norm,
)
from .recurrent import (
    RGLRU,
    ChannelMix,
    TimeMix,
    rglru_mix,
    rwkv_channel_mix,
    rwkv_time_mix,
)

FAMILIES = ("dense", "ssm", "hybrid")
_NOT_PORTED = {"moe": "10.1", "encdec": "10.2", "vlm": "10.2"}


def _check_family(cfg: ModelConfig, families=FAMILIES, what="") -> None:
    if cfg.family not in families:
        item = _NOT_PORTED.get(cfg.family, "10.3")
        raise NotImplementedError(
            f"{what or 'the model'} of the {cfg.family!r} family is not ported "
            f"yet (ROADMAP queue 1, item {item})")


# ----------------------------------------------------------------------------
# layers, one module per kind
# ----------------------------------------------------------------------------

class _Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.ln1 = param(full(gen, (cfg.d_model,), 0.0, torch.float32))
        self.ln2 = param(full(gen, (cfg.d_model,), 0.0, torch.float32))


class AttentionLayer(_Layer):
    """Kinds ``dense`` and ``attn`` (the hybrid's local attention, windowed
    by ``cfg.window``): attention + MLP."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.attn = Attention(cfg, gen)
        self.mlp = MLP(cfg, gen)

    def forward(self, x, positions):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        x = x + chunked_attention(self.attn, cfg, h, positions,
                                  causal=cfg.causal, window=cfg.window)
        return x + mlp(self.mlp, cfg, rms_norm(x, self.ln2, cfg.norm_eps))

    def decode(self, x, k_cache, v_cache, position):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        a, _, _ = decode_attention(self.attn, cfg, h, k_cache, v_cache, position,
                                   window=cfg.window)
        x = x + a
        return x + mlp(self.mlp, cfg, rms_norm(x, self.ln2, cfg.norm_eps))


class RecurrentLayer(_Layer):
    """Kind ``rec``: the RG-LRU block + MLP, from a zero state."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.rec = RGLRU(cfg, gen)
        self.mlp = MLP(cfg, gen)

    def forward(self, x, positions):
        cfg = self.cfg
        # conv_state None: the causal conv starts from zero inputs
        out, _ = rglru_mix(self.rec, cfg, rms_norm(x, self.ln1, cfg.norm_eps), None)
        x = x + out
        return x + mlp(self.mlp, cfg, rms_norm(x, self.ln2, cfg.norm_eps))


class RwkvLayer(_Layer):
    """Kind ``rwkv``: time mix + channel mix, from a zero state."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.time = TimeMix(cfg, gen)
        self.channel = ChannelMix(cfg, gen)

    def forward(self, x, positions):
        cfg = self.cfg
        # the token shift's zero predecessor; the scan starts from S = 0
        zero = x.new_zeros(x.shape[0], cfg.d_model)
        out, _ = rwkv_time_mix(self.time, cfg, rms_norm(x, self.ln1, cfg.norm_eps), zero)
        x = x + out
        out2, _ = rwkv_channel_mix(self.channel, cfg, rms_norm(x, self.ln2, cfg.norm_eps),
                                   zero)
        return x + out2


LAYERS = {"dense": AttentionLayer, "attn": AttentionLayer, "rec": RecurrentLayer,
          "rwkv": RwkvLayer}


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

class Model(nn.Module):
    """The parameters of one model, with the full-sequence forward."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.embed = param(dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=0.02))
        self.ln_f = param(full(gen, (cfg.d_model,), 0.0, torch.float32))
        if not cfg.tied_embeddings:
            self.head = param(dense_init(gen, (cfg.d_model, cfg.vocab_size), dt))
        types = cfg.layer_types()
        if cfg.family == "hybrid":
            pat = cfg.pattern
            nb = cfg.num_layers // len(pat)
            self.blocks = nn.ModuleList(
                nn.ModuleDict({f"l{i}_{kind}": LAYERS[kind](cfg, gen)
                               for i, kind in enumerate(pat)})
                for _ in range(nb))
            self.tail = nn.ModuleList(LAYERS[kind](cfg, gen)
                                      for kind in types[nb * len(pat):])
        else:
            self.layers = nn.ModuleList(LAYERS[types[0]](cfg, gen)
                                        for _ in range(cfg.num_layers))

    def stack(self):
        """The layers in the order they run."""
        if self.cfg.family == "hybrid":
            for block in self.blocks:
                yield from block.values()
            yield from self.tail
        else:
            yield from self.layers

    def logits(self, x):
        x = rms_norm(x, self.ln_f, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tied_embeddings else self.head
        return x @ head

    def forward(self, tokens):
        """tokens: (B, S) integer on the parameters' device -> (B, S, V)."""
        b, s = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        for layer in self.stack():
            x = layer(x, positions)
        return self.logits(x)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Parameters at the reference's initial scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the reference's
    ``jax.random`` draws cannot be reproduced; tests carry the reference's
    parameters across with ``interop.params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, gen)


def _tokens(params: Model, batch) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=params.embed.device).long()


def forward(cfg: ModelConfig, params: Model, batch) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V) in the model's type."""
    if cfg != params.cfg:
        raise ValueError("the parameters were built for another config")
    with torch.no_grad():
        return params(_tokens(params, batch))


# ----------------------------------------------------------------------------
# decode (serving), dense family
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    _check_family(cfg, ("dense",), "decode")
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev)}


def decode_step(cfg: ModelConfig, params: Model, cache: dict, tokens, position):
    """One decode step.  tokens: (B, 1); position: a scalar (the same for the
    whole batch) or (B,) per-slot positions, so continuous batching can
    rewind an admitted slot to 0 without it attending to the previous
    occupant's stale entries.  The cache is updated in place and returned.
    Returns (logits (B, V), cache)."""
    _check_family(cfg, ("dense",), "decode")
    with torch.no_grad():
        x = params.embed[_tokens(params, {"tokens": tokens})]
        for i, layer in enumerate(params.layers):
            x = layer.decode(x, cache["k"][i], cache["v"][i], position)
        return params.logits(x)[:, 0, :], cache


def prefill(cfg: ModelConfig, params: Model, batch, max_len: int):
    """Full forward + a decode cache, as the reference's ``prefill`` (which
    returns a fresh cache).  Returns (logits, cache)."""
    logits = forward(cfg, params, batch)
    return logits, init_cache(cfg, logits.shape[0], max_len, params.embed.device)
