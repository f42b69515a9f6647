"""Fault-tolerance runtime: retry/backoff, preemption handling, straggler
detection, and the restartable training loop's glue (a copy of the
reference's ``runtime/fault_tolerance.py``, which is numpy-only: the port
imports nothing of the reference package).

At 1000+ nodes the failure model is: (a) preemption signals (evictions),
(b) hard node loss (job restarts from the latest atomic checkpoint, possibly
with a different device count — checkpoint restore reshards), (c) stragglers
(slow hosts detected from step-time outliers; the hook evicts/repairs).
This module implements the host-side machinery and is exercised by unit
tests with simulated failures.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np


def retry_with_backoff(
    fn: Callable,
    max_attempts: int = 5,
    base_delay: float = 0.05,
    retryable: tuple = (RuntimeError, OSError),
    on_retry: Optional[Callable] = None,
):
    """Run fn() with exponential backoff on transient failures."""
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:  # noqa: PERF203
            attempt += 1
            if attempt >= max_attempts:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(base_delay * (2 ** (attempt - 1)))


class PreemptionHandler:
    """Latches SIGTERM/SIGINT so the step loop can checkpoint and exit
    cleanly.  ``install()`` is idempotent; tests trigger via ``simulate()``."""

    def __init__(self):
        self._flag = threading.Event()
        self._installed = False

    def install(self):
        if self._installed:
            return
        try:
            signal.signal(signal.SIGTERM, lambda *_: self._flag.set())
            self._installed = True
        except ValueError:
            pass  # not on main thread (tests)

    def simulate(self):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    ratio: float


class StragglerMonitor:
    """Tracks step times; flags steps slower than ``threshold`` x running
    median.  On a real fleet the callback triggers host eviction / hot-spare
    swap; here it feeds metrics + tests."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 callback: Optional[Callable[[StragglerReport], None]] = None):
        self.threshold = threshold
        self.window = window
        self.callback = callback
        self.times: list = []
        self.reports: list = []

    def record(self, step: int, step_time: float):
        self.times.append(step_time)
        hist = self.times[-self.window:]
        med = float(np.median(hist[:-1])) if len(hist) > 1 else step_time
        if med > 0 and step_time > self.threshold * med:
            rep = StragglerReport(step, step_time, med, step_time / med)
            self.reports.append(rep)
            if self.callback:
                self.callback(rep)


class DeterministicSkipper:
    """Deterministic data-order resume: batch at step s is a pure function of
    (seed, s), so restarting from a checkpoint at step s replays the exact
    stream without storing loader state."""

    def __init__(self, seed: int):
        self.seed = seed

    def batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))
