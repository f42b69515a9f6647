"""Model assembly: decoder LMs (dense / MoE / VLM), RWKV6, RecurrentGemma-style
hybrids and the Whisper-style encoder-decoder (the reference's
``models/model.py``), with the reference's interface:

    init_params(cfg, seed, device)                 -> Model (the parameters)
    forward(cfg, params, batch)                    -> logits        (prefill)
    loss_fn(cfg, params, batch)                    -> scalar loss   (training)
    init_cache(cfg, batch, max_len, device)        -> cache
    decode_step(cfg, params, cache, tokens, pos)   -> (logits, cache)
    prefill(cfg, params, batch, max_len)           -> (logits, cache)

``batch`` is a dict ``{"tokens": (B, S)}`` plus, per modality,
``{"frames": (B, T_enc, d)}`` (the encoder-decoder's precomputed audio
frames) or ``{"patches": (B, P, d)}`` (the VLM's precomputed patch
embeddings, prepended to the tokens when given).  The parameters are a
:class:`Model`: one ``nn.Module`` per layer in an ``nn.ModuleList``
(``layers`` for the decoder stack; ``enc`` for the encoder; ``blocks`` of
the hybrid pattern and a ``tail``), named after the reference tree's keys,
so ``repro_torch.interop.params_from_jax`` is a name map that unstacks the
reference's scanned axes.  A cache is the reference's tree of tensors,
stacked over layers the same way, and ``decode_step`` updates it in place.
The reference's activation-sharding annotations are layout hints with no
numeric effect; ``launch/sharding.py`` holds the rules, the parameters'
specs come from ``models/partition.py``, and the MoE dispatch keeps one
capacity group per batch shard under a sharding context.

On a sharded model (``models.partition.shard_params``, run under
``sharding_context`` on a multi-process mesh by ``train.make_train_step``)
every layer reads its parameters through ``train.sharded``'s prologue
inside the layer, so a remat recomputation gathers its weights again; the
vocabulary splits over "model" (the lookup masks other ranks' rows and
sums, the logits are the rank's columns and ``loss_fn``'s cross entropy
all-reduces their max and sum of exponents).

Under ``cfg.remat`` a forward that records gradients runs each layer in
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its layer
scan); ``remat_policy="dots"`` keeps the matrix products' outputs and
recomputes the rest (``checkpoint_dots``).  Neither changes a gradient.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..launch.sharding import in_same_context
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    MetaGenerator,
    MoE,
    attention_params,
    chunked_attention,
    cross_decode_attention,
    decode_attention,
    dense_init,
    dtype_of,
    full,
    mlp,
    sharded_ops,
    moe_mlp,
    param,
    ring_decode_attention,
    rms_norm,
    self_attention,
)
from .recurrent import (
    RGLRU,
    ChannelMix,
    TimeMix,
    rglru_mix,
    rglru_state_init,
    rwkv_channel_mix,
    rwkv_state_init,
    rwkv_time_mix,
)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# top-level keys of the reference tree whose leaves are stacked over layers
# (``jax.vmap`` of the layer init): ``layers`` over the decoder's depth,
# ``enc`` over the encoder's, ``blocks`` over the hybrid's pattern blocks
STACKED = ("layers", "enc", "blocks")


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
    by ``cfg.window``): attention (latent where the config has a KV latent)
    + MLP."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.attn = attention_params(cfg, gen)
        self.mlp = MLP(cfg, gen)

    def ffn(self, h):
        return mlp(self.mlp, self.cfg, h)

    def forward(self, x, positions):
        cfg, own = self.cfg, sharded_ops().view(self)
        h = rms_norm(x, own.ln1, cfg.norm_eps)
        x = x + self_attention(self.attn, cfg, h, positions,
                               causal=cfg.causal, window=cfg.window)
        return x + self.ffn(rms_norm(x, own.ln2, cfg.norm_eps))

    def decode(self, x, k_cache, v_cache, position, slots=None):
        """One token against this layer's cache block; ``slots``: the model
        ranks that split its slots (``train.sharded.slots_tp``)."""
        cfg, own = self.cfg, sharded_ops().view(self)
        h = rms_norm(x, own.ln1, cfg.norm_eps)
        a, _, _ = decode_attention(self.attn, cfg, h, k_cache, v_cache, position,
                                   window=cfg.window, slots=slots)
        x = x + a
        return x + self.ffn(rms_norm(x, own.ln2, cfg.norm_eps))

    def ring_decode(self, x, k_cache, v_cache, position, w, slots=None):
        """The hybrid's decode: local attention over a ring of ``w`` slots."""
        cfg, own = self.cfg, sharded_ops().view(self)
        h = rms_norm(x, own.ln1, cfg.norm_eps)
        x = x + ring_decode_attention(self.attn, cfg, h, k_cache, v_cache, position, w,
                                      slots=slots)
        return x + self.ffn(rms_norm(x, own.ln2, cfg.norm_eps))


class MoeLayer(AttentionLayer):
    """Kind ``moe``: attention + the MoE MLP."""

    def __init__(self, cfg, gen):
        _Layer.__init__(self, cfg, gen)
        self.attn = attention_params(cfg, gen)
        self.moe = MoE(cfg, gen)

    def ffn(self, h):
        return moe_mlp(self.moe, self.cfg, h)


class EncLayer(_Layer):
    """Kind ``enc``: the encoder's bias-free attention, not causal and
    without RoPE (positions come from the sinusoidal table), + MLP."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.attn = Attention(cfg, gen, bias=False)
        self.mlp = MLP(cfg, gen)

    def forward(self, x, positions):
        cfg, own = self.cfg, sharded_ops().view(self)
        h = rms_norm(x, own.ln1, cfg.norm_eps)
        x = x + chunked_attention(self.attn, cfg, h, positions, causal=False,
                                  window=cfg.window, use_rope=False)
        return x + mlp(self.mlp, cfg, rms_norm(x, own.ln2, cfg.norm_eps))


class DecLayer(_Layer):
    """Kind ``dec``: causal self-attention, then (after ``lnx``)
    cross-attention over the encoder's output, + MLP; bias-free, no RoPE."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.attn = Attention(cfg, gen, bias=False)
        self.xattn = Attention(cfg, gen, bias=False)
        self.lnx = param(full(gen, (cfg.d_model,), 0.0, torch.float32))
        self.mlp = MLP(cfg, gen)

    def forward(self, x, positions, enc_out, enc_positions):
        cfg, own = self.cfg, sharded_ops().view(self)
        h = rms_norm(x, own.ln1, cfg.norm_eps)
        x = x + chunked_attention(self.attn, cfg, h, positions, causal=cfg.causal,
                                  window=cfg.window, use_rope=False)
        hx = rms_norm(x, own.lnx, cfg.norm_eps)
        x = x + chunked_attention(self.xattn, cfg, hx, positions, kv_x=enc_out,
                                  kv_positions=enc_positions, causal=False,
                                  use_rope=False)
        return x + mlp(self.mlp, cfg, rms_norm(x, own.ln2, cfg.norm_eps))

    def decode(self, x, k_cache, v_cache, position, xk, xv, slots=None, frames=None):
        cfg, own = self.cfg, sharded_ops().view(self)
        h = rms_norm(x, own.ln1, cfg.norm_eps)
        a, _, _ = decode_attention(self.attn, cfg, h, k_cache, v_cache, position,
                                   window=cfg.window, use_rope=False, slots=slots)
        x = x + a
        hx = rms_norm(x, own.lnx, cfg.norm_eps)
        x = x + cross_decode_attention(self.xattn, cfg, hx, xk, xv, cfg.encoder_seq,
                                       frames=frames)
        return x + mlp(self.mlp, cfg, rms_norm(x, own.ln2, cfg.norm_eps))


class RecurrentLayer(_Layer):
    """Kind ``rec``: the RG-LRU block + MLP."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.rec = RGLRU(cfg, gen)
        self.mlp = MLP(cfg, gen)

    def _mix(self, x, h0, conv):
        cfg, own = self.cfg, sharded_ops().view(self)
        out, h_t, conv = rglru_mix(self.rec, cfg, rms_norm(x, own.ln1, cfg.norm_eps),
                                   h0, conv)
        x = x + out
        return x + mlp(self.mlp, cfg, rms_norm(x, own.ln2, cfg.norm_eps)), h_t, conv

    def forward(self, x, positions):
        return self._mix(x, None, None)[0]  # from zeros, through K7

    def decode(self, x, state):
        """One step from ``state`` {"h", "conv"}; returns (x, new state)."""
        x, h_t, conv = self._mix(x, state["h"], state["conv"])
        return x, {"h": h_t, "conv": conv}


class RwkvLayer(_Layer):
    """Kind ``rwkv``: time mix + channel mix."""

    def __init__(self, cfg, gen):
        super().__init__(cfg, gen)
        self.time = TimeMix(cfg, gen)
        self.channel = ChannelMix(cfg, gen)

    def _mix(self, x, s, last_time, last_chan):
        cfg, own = self.cfg, sharded_ops().view(self)
        out, s, last_t = rwkv_time_mix(self.time, cfg, rms_norm(x, own.ln1, cfg.norm_eps),
                                       s, last_time)
        x = x + out
        out2, last_c = rwkv_channel_mix(self.channel, cfg,
                                        rms_norm(x, own.ln2, cfg.norm_eps), last_chan)
        return x + out2, {"s": s, "last_time": last_t, "last_chan": last_c}

    def forward(self, x, positions):
        # the token shift's zero predecessor; the scan starts from S = 0
        zero = x.new_zeros(x.shape[0], self.cfg.d_model)
        return self._mix(x, None, zero, zero)[0]

    def decode(self, x, state):
        """One step from ``state`` {"s", "last_time", "last_chan"}; returns
        (x, new state)."""
        return self._mix(x, state["s"], state["last_time"], state["last_chan"])


LAYERS = {"dense": AttentionLayer, "attn": AttentionLayer, "moe": MoeLayer,
          "rec": RecurrentLayer, "rwkv": RwkvLayer, "enc": EncLayer, "dec": DecLayer}


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

# the matrix products whose outputs remat_policy="dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_layer(cfg: ModelConfig, layer, *args):
    """``layer(*args)``, under activation checkpointing when ``cfg.remat``
    holds and autograd is recording.  The recomputation runs in the sharding
    context of the forward (``launch.sharding.in_same_context``): on a card
    the autograd engine runs it on a thread of its own."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer(*args)
    layer = in_same_context(layer)
    if cfg.remat_policy == "dots":
        return checkpoint(layer, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_dots))
    return checkpoint(layer, *args, use_reentrant=False)


def sinusoidal(seq: int, d: int, device) -> torch.Tensor:
    """The reference's ``_sinusoidal`` position table (seq, d), f32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


class Model(nn.Module):
    """The parameters of one model, with the full-sequence forward."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
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
        elif cfg.family == "encdec":
            self.enc = nn.ModuleList(EncLayer(cfg, gen) for _ in range(cfg.encoder_layers))
            self.layers = nn.ModuleList(DecLayer(cfg, gen) for _ in range(cfg.num_layers))
            self.ln_enc = param(full(gen, (cfg.d_model,), 0.0, torch.float32))
        else:
            self.layers = nn.ModuleList(LAYERS[kind](cfg, gen) for kind in types)
        if cfg.num_patches:
            self.patch_proj = param(dense_init(gen, (cfg.d_model, cfg.d_model), dt))

    def stack(self):
        """The decoder's layers in the order they run."""
        if self.cfg.family == "hybrid":
            for block in self.blocks:
                yield from block.values()
            yield from self.tail
        else:
            yield from self.layers

    def logits(self, x, top=None):
        """(B, S, V) logits of the last hidden states; on a sharded model
        whose vocabulary is split, the rank's columns."""
        top, tp = top or sharded_ops().top(self)
        x = tp.enter(rms_norm(x, top.ln_f, self.cfg.norm_eps))
        head = top.embed.T if self.cfg.tied_embeddings else top.head
        return x @ head

    def forward(self, tokens, patches=None, frames=None):
        """tokens: (B, S) integer on the parameters' device; patches (B, P,
        d) for a VLM (optional), frames (B, T_enc, d) for the
        encoder-decoder -> (B, P + S, V)."""
        top = sharded_ops().top(self)
        return self.logits(self.hidden(tokens, patches, frames, top), top)

    def hidden(self, tokens, patches=None, frames=None, top=None):
        """The last layer's output (B, P + S, d), before the final norm;
        ``top`` is :func:`train.sharded.top` of the model when the caller
        has it (the embedding gathered once for the lookup and the tied
        logits)."""
        top, tp = top or sharded_ops().top(self)
        if self.cfg.family == "encdec":
            return self._hidden_encdec(top, tp, tokens, frames)
        x = sharded_ops().embed(top.embed, tokens, tp)
        if self.cfg.num_patches and patches is not None:
            x = torch.cat([patches.to(x.dtype) @ top.patch_proj, x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        for layer in self.stack():
            x = _run_layer(self.cfg, layer, x, positions)
        return x

    def _hidden_encdec(self, top, tp, tokens, frames):
        if frames is None:
            raise ValueError("the encoder-decoder reads batch['frames'] (B, T_enc, d)")
        cfg, dt = self.cfg, top.embed.dtype
        b, t_enc, _ = frames.shape
        enc = frames.to(dt) + sinusoidal(t_enc, cfg.d_model, frames.device).to(dt)
        enc_pos = torch.arange(t_enc, device=enc.device)[None, :].expand(b, t_enc)
        for layer in self.enc:
            enc = _run_layer(cfg, layer, enc, enc_pos)
        enc = rms_norm(enc, top.ln_enc, cfg.norm_eps)
        s = tokens.shape[1]
        x = sharded_ops().embed(top.embed, tokens, tp) + \
            sinusoidal(s, cfg.d_model, tokens.device).to(dt)
        pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
        for layer in self.layers:
            x = _run_layer(cfg, layer, x, pos, enc, enc_pos)
        return x


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Parameters at the reference's initial scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the reference's
    ``jax.random`` draws cannot be reproduced; tests carry the reference's
    parameters across with ``interop.params_from_jax``).  On ``"meta"`` the
    same modules, leaf for leaf and shape for shape, with nothing drawn."""
    dev = resolve_device(device)
    gen = MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, gen)


def _on(params: Model, x, dtype=None):
    return None if x is None else torch.as_tensor(x, device=params.embed.device, dtype=dtype)


def forward(cfg: ModelConfig, params: Model, batch) -> torch.Tensor:
    """Full-sequence forward -> logits (B, P + S, V) in the model's type.
    Reads ``batch["patches"]`` (VLM) and ``batch["frames"]`` (encoder-
    decoder) when given."""
    if cfg != params.cfg:
        raise ValueError("the parameters were built for another config")
    with torch.no_grad():
        return params(_on(params, batch["tokens"]).long(), _on(params, batch.get("patches")),
                      _on(params, batch.get("frames")))


# ----------------------------------------------------------------------------
# the loss (training)
# ----------------------------------------------------------------------------

class _CEBf16(torch.autograd.Function):
    """The reference's ``_ce_bf16``: next-token NLL from an f32 log-softmax,
    whose backward recomputes the softmax in f32 and casts the cotangent
    leaving it to the logits' type."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, targets[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        p = torch.softmax(logits.float(), dim=-1)
        p.scatter_add_(-1, targets[..., None],
                       torch.full_like(targets[..., None], -1.0, dtype=p.dtype))
        return (p * g[..., None]).to(logits.dtype), None


def _ce_bf16(logits, targets):
    return _CEBf16.apply(logits, targets)


def loss_fn(cfg: ModelConfig, params: Model, batch) -> torch.Tensor:
    """Next-token cross entropy over the text positions (the reference's
    ``loss_fn``): a VLM's patch positions are dropped, and ``loss_mask``
    (B, S), when given, weights the targets of positions 1.. .  Runs the
    model with autograd recording (``forward`` does not).

    On a sharded model ``batch`` is the rank's rows of the (micro)batch:
    the loss is their share of the whole batch's, their weighted sum over
    the weight of every rank's rows (``train.sharded.batch_total``), so
    summing it over the batch axes gives the reference's loss; with the
    vocabulary split the cross entropy is vocab-parallel."""
    if cfg != params.cfg:
        raise ValueError("the parameters were built for another config")
    sh = sharded_ops()
    tokens = _on(params, batch["tokens"]).long()
    patches = batch.get("patches")
    top = sh.top(params)
    x = params.hidden(tokens, _on(params, patches), _on(params, batch.get("frames")), top)
    logits = params.logits(x, top)
    if cfg.num_patches and patches is not None:
        logits = logits[:, patches.shape[1]:, :]
    targets = tokens[:, 1:]
    logits = logits[:, :-1, :]
    if top[1].n > 1:
        nll = sh.vocab_parallel_nll(logits, targets, top[1])
    elif cfg.bf16_backward:
        nll = _ce_bf16(logits, targets)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = None if mask is None else _on(params, mask, torch.float32)[:, 1:]
    if sh.sharded(params):
        weight = nll.new_tensor(float(nll.numel())) if mask is None else mask.sum()
        total = sh.batch_total(weight)
        nll = nll if mask is None else nll * mask
        return nll.sum() / total.clamp_min(1.0)
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


# ----------------------------------------------------------------------------
# decode (serving)
# ----------------------------------------------------------------------------

def _stacked(state: dict, n: int) -> dict:
    """Zero states ``state`` stacked over ``n`` layers."""
    return {k: v.new_zeros((n,) + tuple(v.shape)) for k, v in state.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda", mesh=None,
               rules=None) -> dict:
    """The reference's cache tree: K/V rows by absolute position (dense,
    moe, vlm; encdec adds ``xk`` / ``xv`` over the encoder frames, padded
    to a multiple of 64), the RWKV6 state stacked over layers (ssm), or
    the hybrid's RG-LRU states and ring buffers of ``min(window, max_len)``
    slots for its ``blocks`` and ``tail``.  With a multi-process ``mesh``
    and ``rules``, zeros laid out as ``partition.shard_cache`` lays out a
    cache (each rank allocates only its blocks, on the mesh's device)."""
    if cfg.is_mla:
        raise NotImplementedError("latent attention has no decode cache: the port only "
                                  "prefills it (forward)")
    if mesh is not None:
        from .partition import zeros_cache

        return zeros_cache(init_cache(cfg, batch, max_len, "meta"), mesh, rules)
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == "ssm":
        return {"state": _stacked(rwkv_state_init(cfg, batch, dev), cfg.num_layers)}
    if cfg.family == "hybrid":
        pat = cfg.pattern
        nb = cfg.num_layers // len(pat)
        w = min(cfg.window if cfg.window else max_len, max_len)
        ring = (batch, w, nkv, hd)
        block = {}
        for i, kind in enumerate(pat):
            if kind == "rec":
                block[f"l{i}_state"] = _stacked(rglru_state_init(cfg, batch, dev), nb)
            else:
                block[f"l{i}_k"] = torch.zeros((nb,) + ring, dtype=dt, device=dev)
                block[f"l{i}_v"] = torch.zeros((nb,) + ring, dtype=dt, device=dev)
        tail = []
        for kind in cfg.layer_types()[nb * len(pat):]:
            if kind == "rec":
                tail.append({"state": rglru_state_init(cfg, batch, dev)})
            else:
                tail.append({"k": torch.zeros(ring, dtype=dt, device=dev),
                             "v": torch.zeros(ring, dtype=dt, device=dev)})
        return {"blocks": block, "tail": tail}
    shape = (cfg.num_layers, batch, max_len, nkv, hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.family == "encdec":
        # the decode cross-attention masks the frames >= cfg.encoder_seq
        t_enc = -(-cfg.encoder_seq // 64) * 64
        xshape = (cfg.num_layers, batch, t_enc, nkv, hd)
        cache["xk"] = torch.zeros(xshape, dtype=dt, device=dev)
        cache["xv"] = torch.zeros(xshape, dtype=dt, device=dev)
    return cache


def _step_state(layer, x, stacked: dict, i: int):
    """Run ``layer.decode`` on layer ``i``'s slice of a stacked state and
    write the new state back into it."""
    x, new = layer.decode(x, {k: v[i] for k, v in stacked.items()})
    for k, v in new.items():
        stacked[k][i] = v
    return x


def decode_step(cfg: ModelConfig, params: Model, cache: dict, tokens, position):
    """One decode step.  tokens: (B, 1); position: a scalar (the same for the
    whole batch) or, where ``cfg.has_positional_cache`` holds, (B,) per-slot
    positions, so continuous batching can rewind an admitted slot to 0
    without it attending to the previous occupant's stale entries.  The
    recurrent families (ssm, hybrid) take the scalar form only; their
    batcher gates admission instead.  The cache is updated in place and
    returned.  Returns (logits (B, V), cache).

    On a sharded model (under ``sharding_context``, the reference's
    ``DECODE_RULES``) ``tokens`` and per-slot positions are the rank's rows
    of the batch, the cache is laid out by ``partition.shard_cache`` (its
    blocks written in place: slots split over "model" go to their owner)
    and the logits are the rank's rows and vocabulary columns."""
    if cfg.is_mla:
        raise NotImplementedError("latent attention has no decode step: the port only "
                                  "prefills it (forward)")
    with torch.no_grad():
        sh = sharded_ops()
        top = sh.top(params)
        x = sh.embed(top[0].embed, _on(params, tokens).long(), top[1])
        blocks = sh.local_tree(cache)
        if cfg.family == "ssm":
            for i, layer in enumerate(params.layers):
                x = _step_state(layer, x, blocks["state"], i)
        elif cfg.family == "hybrid":
            x = _decode_hybrid(cfg, params, cache, blocks, x, position)
        elif cfg.family == "encdec":
            slots, frames = sh.slots_tp(cache["k"]), sh.slots_tp(cache["xk"])
            for i, layer in enumerate(params.layers):
                x = layer.decode(x, blocks["k"][i], blocks["v"][i], position,
                                 blocks["xk"][i], blocks["xv"][i], slots, frames)
        else:
            slots = sh.slots_tp(cache["k"])
            for i, layer in enumerate(params.layers):
                x = layer.decode(x, blocks["k"][i], blocks["v"][i], position, slots)
        return params.logits(x, top)[:, 0, :], cache


def _decode_hybrid(cfg, params, cache, blocks, x, position):
    """The hybrid's layers, one step: ``blocks`` is ``cache``'s local
    blocks, the ring's width ``w`` the cache's (global) slots."""
    sh = sharded_ops()
    pat = cfg.pattern
    attn_i = next(i for i, kind in enumerate(pat) if kind == "attn")
    ring = cache["blocks"][f"l{attn_i}_k"]
    w, slots = ring.shape[2], sh.slots_tp(ring)
    for b, block in enumerate(params.blocks):
        for i, kind in enumerate(pat):
            layer = block[f"l{i}_{kind}"]
            if kind == "rec":
                x = _step_state(layer, x, blocks["blocks"][f"l{i}_state"], b)
            else:
                x = layer.ring_decode(x, blocks["blocks"][f"l{i}_k"][b],
                                      blocks["blocks"][f"l{i}_v"][b], position, w, slots)
    for layer, c, whole_c in zip(params.tail, blocks["tail"], cache["tail"]):
        if isinstance(layer, RecurrentLayer):
            x, new = layer.decode(x, c["state"])
            for k, v in new.items():
                c["state"][k].copy_(v)
        else:
            x = layer.ring_decode(x, c["k"], c["v"], position, w, sh.slots_tp(whole_c["k"]))
    return x


def prefill(cfg: ModelConfig, params: Model, batch, max_len: int):
    """Full forward + a decode cache, as the reference's ``prefill`` (which
    returns a fresh cache).  Returns (logits, cache).  On a sharded model
    (under ``sharding_context``) the batch is the rank's rows, and the
    fresh cache, of those rows times the batch shards, is laid out by
    ``partition.shard_cache`` under the active rules."""
    logits = forward(cfg, params, batch)
    if not sharded_ops().sharded(params):
        return logits, init_cache(cfg, logits.shape[0], max_len, params.embed.device)
    from ..launch import sharding as S

    mesh, rules = S._CTX.mesh, S._CTX.rules
    rows = logits.shape[0] * S.mesh_batch_shards(mesh, rules)
    return logits, init_cache(cfg, rows, max_len, mesh=mesh, rules=rules)
