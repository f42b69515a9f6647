"""Launch-parameter autotuner of the similarity kernels (the reference's
``kernels/autotune.py``).

The tile kernel of ``csrc/sim_kernels.cu`` takes two launch parameters that
leave every count tile and top-k list as they are: the CTA tile rows
(``cuda_lib.CTA_ROWS``, or ``WIDE_ROWS`` where ``cuda_lib.tile_rows``
allows the wide tile) and the column split (``cuda_lib.column_splits``'
choice, here times 1, 2 or 4).  ``cuda_lib`` picks both by fixed rules,
measured on the card; once a cache file is configured this module measures
the candidates on first use per (op, card, precision, power-of-two shape
bucket), keeps the winner in memory and in the file, and the launch takes
it.  It never changes a launch's count tile rows (``bm``), so an index's
strides keep nesting.

Behaviour contract:

* Tuning is on once :func:`configure` names the cache file (an
  ``IndexStore`` with a root does, as in the reference); until then, and
  for CPU tensors always, :func:`schedule` returns ``None``, measures
  nothing, and every launch keeps the fixed rules.  (The reference also
  measures without a file; the port keeps untuned runs on the rules its
  bit-for-bit records were taken with.)
* Shapes are bucketed to powers of two; one measurement serves every shape
  in the bucket.  The key is (op, ``torch.cuda.get_device_name()`` with
  spaces replaced, precision, bucket).
* The cache is one JSON file, written atomically; a corrupt file is
  measured again and overwritten.
* Candidates are timed with CUDA events on the card's current stream.  A
  candidate whose shared memory does not fit is left out before any
  launch; one that fails to launch is an error (the port has no
  degradation policy).
* A column split merges the walk sums of its ranges by two-sum, and the
  tile width orders a row's sum, so a tuned launch's sums may differ from
  the default launch's in the last bits (within the 1e-6 contract); the
  winner is fixed per bucket for the life of the cache, so a run's builds,
  appends and queries at one shape agree bit for bit.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch

OPS = ("sim_sweep", "sim_hist", "sim_topk")
SPLIT_FACTORS = (1, 2, 4)   # multiples of column_splits' choice

_lock = threading.Lock()
_memory: dict[str, tuple[int, int]] = {}
_seconds: dict[str, float] = {}
_path: Optional[str] = None
_loaded = False


def configure(path) -> None:
    """Point the disk cache at ``path`` (a JSON file) and turn tuning on.
    Existing entries are merged into memory on the next :func:`schedule`."""
    global _path, _loaded
    with _lock:
        _path = os.fspath(path) if path is not None else None
        _loaded = False


def reset() -> None:
    """Drop the in-memory cache and the disk path: tuning off."""
    global _path, _loaded
    with _lock:
        _memory.clear()
        _seconds.clear()
        _path = None
        _loaded = False


def cache_info() -> dict[str, tuple[int, int]]:
    """{key: (tile rows, split factor)} in memory."""
    with _lock:
        return dict(_memory)


def tuning_seconds() -> dict[str, float]:
    """{key: seconds} that this process spent measuring each entry."""
    with _lock:
        return dict(_seconds)


def _bucket(x: int) -> int:
    return max(8, 1 << (max(int(x), 1) - 1).bit_length())


def _key(op: str, device_kind: str, precision: str, m: int, n: int, d: int) -> str:
    return f"{op}/cuda/{device_kind}/{precision}/{_bucket(m)}x{_bucket(n)}x{_bucket(d)}"


def _device_kind(device) -> str:
    return torch.cuda.get_device_name(device).replace(" ", "_")


def _load_locked() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    if _path is None or not os.path.exists(_path):
        return
    try:
        with open(_path) as f:
            disk = json.load(f)
        for k, v in disk.items():
            _memory.setdefault(k, (int(v[0]), int(v[1])))
    except (OSError, ValueError, TypeError, IndexError, AttributeError):
        pass  # corrupt cache: measured again and overwritten


def _save_locked() -> None:
    if _path is None:
        return
    os.makedirs(os.path.dirname(_path) or ".", exist_ok=True)
    tmp = f"{_path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump({k: list(v) for k, v in sorted(_memory.items())}, f, indent=1)
    os.replace(tmp, _path)


def candidates(op: str, m: int, n: int, d: int, precision: str, device) -> list:
    """(tile rows, split factor) pairs whose shared memory fits, at the
    bucket shape (one count tile, so the wide tile is allowed where the
    rows exceed a narrow tile)."""
    from . import cuda_lib

    flags, n_bins, k = _launch_kind(op)
    so = cuda_lib.lib()
    rows = [r for r in (cuda_lib.CTA_ROWS, cuda_lib.WIDE_ROWS)
            if cuda_lib.tile_rows(m, m) >= r
            and so.repro_sim_smem_bytes(flags, n_bins, k, r) <= cuda_lib.MAX_SMEM]
    return [(r, f) for r in rows for f in SPLIT_FACTORS]


def _launch_kind(op: str):
    """(epilogue flags, bins, k) a measurement launches with: the sweep's
    and the two-pass kernels' path settings."""
    from . import cuda_lib

    return {"sim_sweep": (cuda_lib.HIST | cuda_lib.TOPK | cuda_lib.SUMS, 4096, 32),
            "sim_hist": (cuda_lib.HIST, 4096, 1),
            "sim_topk": (cuda_lib.TOPK, 1, 32)}[op]


def _time_candidate(op: str, m: int, n: int, d: int, precision: str,
                    rows: int, factor: int, device) -> float:
    """Milliseconds of one launch of the candidate at the bucket shape on
    synthetic data: a warm-up, then the best of three, by CUDA events."""
    from . import cuda_lib
    from .sim_sweep.kernel import kernel_operand

    flags, n_bins, k = _launch_kind(op)
    gen = torch.Generator(device=device).manual_seed(0)
    kw = {}
    if precision == "int8":
        a = torch.randint(-127, 128, (m, d), generator=gen, device=device, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, d), generator=gen, device=device, dtype=torch.int8)
        kw.update(rs1=torch.full((m,), 1 / 127 / d**0.5, device=device),
                  rs2=torch.full((n,), 1 / 127 / d**0.5, device=device))
    else:
        e1 = torch.randn((m, d), generator=gen, device=device) / d**0.5
        e2 = torch.randn((n, d), generator=gen, device=device) / d**0.5
        a, b = kernel_operand(e1, precision), kernel_operand(e2, precision)
    if flags & cuda_lib.HIST:
        kw["scale"] = torch.ones((m,), device=device)
    if flags & cuda_lib.SUMS:
        kw["v"] = torch.ones((n,), device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = apply_split(m, n, sms, rows, factor)

    def run():
        cuda_lib._launch_tile(precision, flags, a, b, n_bins=n_bins, k=min(k, n),
                              bm=m, rows=rows, splits=splits, **kw)

    run()
    best = float("inf")
    stream = torch.cuda.current_stream(device)
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        run()
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _measure(op: str, m: int, n: int, d: int, precision: str, device,
             cands) -> tuple[int, int]:
    """The fastest candidate (the first of equals)."""
    times = [(_time_candidate(op, m, n, d, precision, r, f, device), i)
             for i, (r, f) in enumerate(cands)]
    return cands[min(times)[1]]


def apply_split(m: int, n: int, sms: int, rows: int, factor: int) -> int:
    """The column ranges of a launch at ``factor`` times the fixed rule's
    choice, as a count the kernel accepts."""
    from . import cuda_lib

    return cuda_lib.range_count(-(-n // rows), cuda_lib.column_splits(m, n, sms, rows) * factor)


def schedule(op: str, m: int, n: int, d: int, precision: str = "fp32",
             device=None) -> Optional[tuple[int, int]]:
    """The tuned (tile rows, split factor) of ``op`` at this shape bucket,
    or ``None`` where the launch keeps the fixed rules: no cache is
    configured, or ``device`` is not a CUDA device.  The first use of a
    bucket measures :func:`candidates` and persists the winner."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    with _lock:
        if _path is None:
            return None
        _load_locked()
    key = _key(op, _device_kind(dev), precision, m, n, d)
    with _lock:
        if key in _memory:
            return _memory[key]
    bm, bn, bd = _bucket(m), _bucket(n), _bucket(d)
    t0 = time.perf_counter()
    won = _measure(op, bm, bn, bd, precision, dev, candidates(op, bm, bn, bd, precision, dev))
    with _lock:
        won = _memory.setdefault(key, tuple(won))   # a concurrent first use keeps one winner
        _seconds.setdefault(key, time.perf_counter() - t0)
        _save_locked()
    return won
