"""Serving layer: batched pair scoring (the Oracle endpoint BAS calls) and a
slot-based continuous batcher for autoregressive decode (the reference's
``serve/serve_loop.py``).

PairScorer — the paper's Oracle as a service: serialize a record pair to
tokens, run the scoring LM, read P(match) from the final-position logits of
the YES/NO token ids.  The Oracle batch layer (``repro_torch.core.oracle``)
hands it one deduped request per pipeline stage; the scorer buckets those
requests into a small set of padded (batch, length) shapes — power-of-two
sequence buckets × a fixed batch dim — as the reference does, so every
forward runs at one of O(log max_len) shapes.  With ``mesh=`` (a
one-process mesh, ``launch.mesh.make_host_mesh``) each padded batch is
split over the mesh's batch axes (``launch.sharding.data_parallel``).

ContinuousBatcher — fixed B decode slots; finished sequences vacate their
slot and queued requests are admitted mid-flight (per-slot positions) where
the cache is positional, and in waves where the model carries recurrent
state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..launch.sharding import data_parallel, mesh_batch_shards
from ..obs.telemetry import count, span
from ..models import Model, decode_step, forward, init_cache
from ..models.config import ModelConfig


def _stable_yes_no_prob(lg: np.ndarray) -> np.ndarray:
    """P(yes) from (n, 2) [yes, no] logits, max-subtracted so large logits
    cannot overflow ``exp`` into NaN."""
    m = lg.max(axis=1, keepdims=True)
    e = np.exp(lg - m)
    return e[:, 0] / (e[:, 0] + e[:, 1])


def _on_device(params: Model, device) -> torch.device:
    dev = resolve_device(device)
    at = params.embed.device
    if at.type != dev.type or (dev.index is not None and at.index != dev.index):
        raise ValueError(f"the parameters lie on {at}, not on {dev}")
    return dev


class PairScorer:
    """Batched Oracle scoring: score(idx_pairs) -> P(match) per pair.

    ``params`` lie on ``device`` (default the card).  ``mesh`` (optional, a
    one-process mesh) enables the data-parallel path: ``batch_size`` is
    rounded up to a multiple of the mesh's batch shards (SERVE_RULES), the
    parameters are replicated once onto each device that takes a slice,
    and each slice runs its own forward — so an MoE's capacity is counted
    per slice, as inside the reference's ``shard_map``.
    ``forward_batches`` counts forward invocations of the whole batch —
    the unit the ceil(unique / batch_size) bound is stated in — and
    ``pairs_scored`` the pairs scored.

    ``score`` is the span ``joinml.score``, split into ``score.tokenize``
    (tokens and each batch's padding), ``score.forward`` (the upload and the
    forward's launches) and ``score.readback`` (the copy to the host, which
    waits for the device); it counts ``scorer.tokens_useful`` (each pair's
    unpadded length) and ``scorer.tokens_forwarded`` (rows, padding rows
    included, times padded length).
    """

    def __init__(self, cfg: ModelConfig, params: Model, tokenize_pair: Callable,
                 yes_id: int, no_id: int, max_len: int = 128,
                 batch_size: int = 32, mesh=None, min_bucket: int = 16,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = _on_device(params, device)
        self.tokenize_pair = tokenize_pair
        self.yes_id, self.no_id = yes_id, no_id
        self.max_len = max_len
        self.mesh = mesh
        fwd = lambda p, b: forward(cfg, p, b)  # noqa: E731
        if mesh is not None:
            shards = mesh_batch_shards(mesh)
            batch_size = -(-batch_size // shards) * shards
            fwd = data_parallel(fwd, mesh)
        self._fwd = fwd
        self.batch_size = batch_size
        self.forward_batches = 0
        self.pairs_scored = 0
        # power-of-two padded lengths: a bounded shape set, so short pairs
        # don't pay max_len compute
        buckets = []
        b = max(min(min_bucket, max_len), 1)
        while b < max_len:
            buckets.append(b)
            b *= 2
        buckets.append(max_len)
        self._buckets = np.array(buckets, np.int64)

    def _tokenize(self, pairs: np.ndarray) -> list:
        return [
            np.asarray(self.tokenize_pair(p), np.int32)[: self.max_len]
            for p in pairs
        ]

    @staticmethod
    def _pad_block(seqs: list, pad_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ragged->padded scatter: one fancy-index assignment for
        the whole block instead of a Python loop over rows."""
        n = len(seqs)
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        toks = np.zeros((n, pad_len), np.int32)
        flat = np.concatenate(seqs) if n else np.zeros(0, np.int32)
        rows = np.repeat(np.arange(n), lens)
        starts = np.cumsum(lens) - lens
        cols = np.arange(int(lens.sum())) - np.repeat(starts, lens)
        toks[rows, cols] = flat
        return toks, np.maximum(lens - 1, 0).astype(np.int32)

    def score(self, pairs: np.ndarray) -> np.ndarray:
        pairs = np.asarray(pairs)
        n = len(pairs)
        if n == 0:
            return np.zeros(0, np.float64)
        with span("joinml.score"):
            with span("joinml.score.tokenize"):
                seqs = self._tokenize(pairs)
            lens = np.fromiter((len(s) for s in seqs), np.int64, n)
            pad_of = self._buckets[np.searchsorted(self._buckets, lens)]
            out = np.empty(n, np.float64)
            bs = self.batch_size
            rows = torch.arange(bs, device=self.device)
            cols = torch.tensor([self.yes_id, self.no_id], device=self.device)
            forwarded = 0
            for pad_len in np.unique(pad_of):
                sel = np.nonzero(pad_of == pad_len)[0]
                for s in range(0, len(sel), bs):
                    idxs = sel[s : s + bs]
                    with span("joinml.score.tokenize"):
                        toks, last = self._pad_block([seqs[i] for i in idxs], int(pad_len))
                        pad_rows = bs - len(idxs)
                        if pad_rows:
                            toks = np.concatenate(
                                [toks, np.zeros((pad_rows, int(pad_len)), np.int32)]
                            )
                            last = np.concatenate([last, np.zeros(pad_rows, np.int32)])
                    with span("joinml.score.forward"):
                        logits = self._fwd(self.params, {
                            "tokens": torch.from_numpy(toks).to(self.device)}).to(self.device)
                        last_t = torch.from_numpy(last).to(self.device).long()
                        lg = logits[rows, last_t][:, cols].double()
                    with span("joinml.score.readback"):
                        lg = lg.cpu().numpy()
                    self.forward_batches += 1
                    forwarded += bs * int(pad_len)
                    out[idxs] = _stable_yes_no_prob(lg)[: len(idxs)]
        self.pairs_scored += n
        count("scorer.tokens_useful", int(lens.sum()))
        count("scorer.tokens_forwarded", forwarded)
        return out


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (L,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching over the single-token decode step.

    Prefill is run through decode steps token-by-token per slot (correct and
    simple; a production setup runs a separate prefill graph).  All slots
    advance together each step; empty slots decode a pad token into a junk
    region that is never read.

    Admission: where ``cfg.has_positional_cache`` holds (dense, moe, vlm,
    encdec) the batcher passes **per-slot positions** to ``decode_step``,
    so a queued request is admitted into any freed slot mid-flight — its
    position rewinds to 0 and the per-slot causal mask keeps it from
    attending to the previous occupant's stale KV entries.  The recurrent
    families (ssm, and the hybrid's ring buffer) carry state that cannot be
    rewound per slot — and even an idle slot absorbs pad tokens into its
    state every step — so admission is gated there: requests are admitted
    only at step 0, and when every slot has drained the batcher resets the
    cache and admits the next wave.
    """

    def __init__(self, cfg: ModelConfig, params: Model, batch_size: int = 4,
                 max_len: int = 256, eos_id: int = 1, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = _on_device(params, device)
        self.b = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = init_cache(cfg, batch_size, max_len, self.device)
        self.slots: list = [None] * batch_size
        self.pos = np.zeros(batch_size, np.int64)         # per-slot next write position
        self.prompt_left: list = [0] * batch_size
        self.queue: list = []
        self.finished: list = []
        self.global_pos = 0
        self.per_slot_pos = cfg.has_positional_cache

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        if not self.per_slot_pos:
            # gated admission (scalar position): recurrent state absorbs pad
            # tokens even in idle slots, so only step 0 is safe; once
            # everything drained, reset the cache and start a new wave
            if self.queue and self.global_pos > 0 and all(s is None for s in self.slots):
                self.cache = init_cache(self.cfg, self.b, self.max_len, self.device)
                self.global_pos = 0
            if self.global_pos != 0:
                return
        for i in range(self.b):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self.prompt_left[i] = len(req.prompt)
                self.pos[i] = 0

    def step(self):
        """Advance every active slot by one token (greedy)."""
        self._admit()
        toks = np.zeros((self.b, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            consumed = len(req.prompt) - self.prompt_left[i]
            if self.prompt_left[i] > 0:
                toks[i, 0] = req.prompt[consumed]
            else:
                toks[i, 0] = req.out_tokens[-1] if req.out_tokens else self.eos_id
        if self.per_slot_pos:
            position = torch.from_numpy(np.minimum(self.pos, self.max_len - 1)).to(self.device)
        else:
            position = self.global_pos
        logits, self.cache = decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device), position,
        )
        logits = logits.float().cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            if self.per_slot_pos and self.pos[i] >= self.max_len:
                # positional cache capacity exhausted (possibly still
                # mid-prompt): keep this step's token if we were generating,
                # then terminate rather than clobber the last KV position.
                # Recurrent families have no positional capacity to exhaust.
                if self.prompt_left[i] <= 1:
                    req.out_tokens.append(int(np.argmax(logits[i])))
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                continue
            if self.prompt_left[i] > 1:
                self.prompt_left[i] -= 1
                continue
            if self.prompt_left[i] == 1:
                self.prompt_left[i] = 0  # last prompt token consumed: sample
            nxt = int(np.argmax(logits[i]))
            req.out_tokens.append(nxt)
            if nxt == self.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
        self.global_pos += 1

    def run_until_done(self, max_steps: int = 10_000):
        while (any(s is not None for s in self.slots) or self.queue) and max_steps:
            self.step()
            max_steps -= 1
        return self.finished
