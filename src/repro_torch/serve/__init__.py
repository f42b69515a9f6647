"""Serving: the batched pair scorer (the Oracle endpoint) and continuous
batching over the decode step."""
from .serve_loop import ContinuousBatcher, PairScorer, Request  # noqa: F401
