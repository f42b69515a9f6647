"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled with ``nvcc`` for ``sm_90a`` into an object file,
all of them at once in parallel, and the objects are linked into one shared
library with a plain C interface, at first use, and loaded with
:mod:`ctypes`.  The library lands in ``build/repro_torch/`` at the root of
the checkout (or in ``$REPRO_TORCH_BUILD_DIR``), named by a hash over every
source and the flags, so a changed source rebuilds and an unchanged tree
loads at once.

Nothing here runs at import time: the CPU tests import every module of the
port, and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = sorted(CSRC.glob("*.cu"))
HEADERS = sorted(CSRC.glob("*.cuh"))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# launch modes and epilogue flags of ``repro_sim_launch``
MODES = {"fp32": 0, "bf16": 1, "int8": 2}
HIST, TOPK, SUMS = 1, 2, 4

# Launch counts, one per kernel: each wrapper adds one (``count_launch``)
# where it launches its kernel and nowhere else.  Keys are the kernel names
# chip_smoke.py reports.  A lock keeps the counts right when kernels launch
# from several threads (an index store's build runs on its caller's thread).
LAUNCHES: Counter = Counter()
_launch_lock = threading.Lock()

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES.clear()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    ``BUILD_INFO`` records the build seconds and the ptxas report."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    out_dir = build_dir()
    out = out_dir / f"librepro_{digest.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(cached build)")
        BUILD_INFO["path"] = str(out)
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, p.returncode, log)
                  for src, p, log in zip(SOURCES, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(so, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log="".join(logs),
                      path=str(out), sources=[s.name for s in SOURCES])
    return out


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            so.repro_sim_launch.argtypes = [
                ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, cf,
                ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp,
            ]
            so.repro_sim_launch.restype = ci
            so.repro_sim_smem_bytes.argtypes = [ci, ci, ci, ci]
            so.repro_sim_smem_bytes.restype = ctypes.c_size_t
            so.repro_topk_few_rows.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp]
            so.repro_topk_few_rows.restype = ci
            so.repro_topk_few_rows_smem_bytes.argtypes = [ci]
            so.repro_topk_few_rows_smem_bytes.restype = ctypes.c_size_t
            so.repro_flash_attention.argtypes = [
                ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, cf, vp,
            ]
            so.repro_flash_attention.restype = ci
            so.repro_flash_smem_bytes.argtypes = [ci, ci, ci, ci, ci, ci, ci]
            so.repro_flash_smem_bytes.restype = ctypes.c_size_t
            so.repro_flash_attention_bwd.argtypes = [
                ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                ci, ci, ci, ci, ci, ci, ci, ci, cf, ci, vp,
            ]
            so.repro_flash_attention_bwd.restype = ci
            so.repro_flash_bwd_smem_bytes.argtypes = [ci, ci]
            so.repro_flash_bwd_smem_bytes.restype = ctypes.c_size_t
            so.repro_rwkv6_scan.argtypes = [
                ci, vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
                ci, ci, ci, ci, ci, vp,
            ]
            so.repro_rwkv6_scan.restype = ci
            so.repro_rwkv6_scan_bwd.argtypes = [
                ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                ctypes.POINTER(ctypes.c_longlong), ci, ci, ci, ci, ci, vp,
            ]
            so.repro_rwkv6_scan_bwd.restype = ci
            so.repro_rwkv6_bwd_smem_bytes.argtypes = [ci, ci]
            so.repro_rwkv6_bwd_smem_bytes.restype = ctypes.c_size_t
            so.repro_rglru_scan.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            so.repro_rglru_scan.restype = ci
            so.repro_rglru_scan_bwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
            so.repro_rglru_scan_bwd.restype = ci
            u64, cu, ll = ctypes.c_uint64, ctypes.c_uint, ctypes.c_longlong
            gen = [vp, u64, u64, u64, u64, ci, cu]  # jump table, state, inc, half-word
            so.repro_boot_detect.argtypes = [
                *gen, ci, vp, vp, vp, vp, vp, ll, ci, vp, vp, vp, vp,
            ]
            so.repro_boot_detect.restype = ci
            so.repro_boot_moments.argtypes = [
                *gen, ci, ci, vp, vp, vp, vp, vp, ci, vp, ci, ci, vp, vp, vp,
            ]
            so.repro_boot_moments.restype = ci
            _lib = so
        return _lib


# Rows of a CTA tile (BM in the source; tiles are square, BN = BM).  A
# launch takes the wide tile (WIDE_ROWS) where its CTAs' rows fall in one
# count tile (``tile_rows``), else the narrow one (CTA_ROWS), whose rows
# divide every count tile the wrapper accepts; CTA_COLS is the narrow
# tile's columns.  A fp32 top-k launch over at most FEW_ROWS rows takes the
# few-row kernels instead (``few_rows``; FR_ROWS in the source).
CTA_ROWS = 64
WIDE_ROWS = 128
CTA_COLS = 64
FEW_ROWS = 32
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_SPLITS = 256   # column ranges a merge takes (32 * MERGE_J)
# bytes a row of the kernel's operands must be a multiple of (16-byte
# cp.async copies), in elements
ALIGN = {"fp32": 4, "bf16": 8, "int8": 16}


def tile_rows(m: int, bm: int) -> int:
    """Rows of the CTA tile of a launch over ``m`` rows whose count tiles
    hold ``bm`` rows each (one tile when ``bm >= m``; pass ``m`` for a
    launch without count tiles): ``WIDE_ROWS`` where the launch has more
    rows than a narrow tile and each count tile holds whole wide tiles,
    else ``CTA_ROWS``."""
    if m > CTA_ROWS and (bm >= m or bm % WIDE_ROWS == 0):
        return WIDE_ROWS
    return CTA_ROWS


def column_splits(m: int, n: int, sms: int, rows: int = CTA_ROWS) -> int:
    """Column ranges of a launch over ``m`` rows in square CTA tiles of
    ``rows`` rows and columns.  A launch with fewer CTA rows than SMs splits
    into enough ranges for four CTAs per SM (several waves, so the last
    one's idle SMs cost little), in whole column tiles, returned as the
    number of ranges that ``ceil(tiles / splits)`` tiles each actually make
    (what the kernel checks).  A launch with a CTA row per SM or more does
    not split: each range starts its top-k lists empty, and their first
    tiles insert the most."""
    ctas = -(-m // rows)
    tiles = -(-n // rows)
    if ctas >= sms:
        return 1
    return range_count(tiles, -(-4 * sms // ctas))


def range_count(tiles: int, want: int) -> int:
    """The column ranges that ``want`` ranges over ``tiles`` column tiles
    actually make, ``ceil(tiles / splits)`` tiles each (what the kernel
    checks), at most ``MAX_SPLITS``."""
    want = max(1, min(want, tiles, MAX_SPLITS))
    per = -(-tiles // want)
    return -(-tiles // per)


topk_splits = column_splits  # the split of a top-k launch at CTA_ROWS rows


def few_rows(mode: str, flags: int, m: int) -> bool:
    """Whether a launch takes the few-row top-k kernels: fp32, top-k only,
    at most ``FEW_ROWS`` rows (the raised-k retry).  Every other launch
    takes the tile kernel."""
    return mode == "fp32" and flags == TOPK and m <= FEW_ROWS


def check_operand(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_strided(t: torch.Tensor, name: str, dtype, shape) -> None:
    """An operand the kernel reads through its strides: the last dimension
    contiguous, every other stride and the start 16-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    size = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(st * size % 16 for st in t.stride()[:-1])):
        raise ValueError(f"{name} must have a contiguous last dimension and "
                         "16-byte aligned strides")


def ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch(mode: str, flags: int, e1: torch.Tensor, e2: torch.Tensor, *,
           rs1=None, rs2=None, scale=None, v=None, n_bins: int = 1,
           exponent: float = 1.0, rs_exponent: float = 1.0,
           floor: float = 1e-3, k: int = 1, bm: int = 1, splits=None):
    """One launch of the fused kernel on the current stream.

    ``e1`` (M, d) and ``e2`` (N, d) are float32, bfloat16 or int8 per
    ``mode``, with d a multiple of ``ALIGN[mode]``.  The kernel
    (:func:`few_rows`: the few-row top-k, else :func:`_launch_tile`) is
    chosen here.  Returns ``(block_counts, vals, idx, row_sums)``; entries
    whose epilogue is off are None."""
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[mode]
    m, d = e1.shape
    n = e2.shape[0]
    if d % ALIGN[mode]:
        raise ValueError(f"d={d} must be a multiple of {ALIGN[mode]} for {mode}")
    check_operand(e1, "e1", dtype, (m, d))
    check_operand(e2, "e2", dtype, (n, d))
    if mode == "int8":
        check_operand(rs1, "rs1", torch.float32, (m,))
        check_operand(rs2, "rs2", torch.float32, (n,))
    if flags & TOPK and not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}]")
    if few_rows(mode, flags, m):
        return (None, *_launch_few_rows(lib(), e1, e2, k), None)
    return _launch_tile(mode, flags, e1, e2, rs1=rs1, rs2=rs2, scale=scale, v=v,
                        n_bins=n_bins, exponent=exponent, rs_exponent=rs_exponent,
                        floor=floor, k=k, bm=bm, splits=splits)


# the autotuner's name of a tile launch, by its epilogues
TUNED_OPS = {HIST | TOPK | SUMS: "sim_sweep", HIST: "sim_hist", TOPK: "sim_topk"}


def _launch_tile(mode: str, flags: int, e1: torch.Tensor, e2: torch.Tensor, *,
                 rs1=None, rs2=None, scale=None, v=None, n_bins: int = 1,
                 exponent: float = 1.0, rs_exponent: float = 1.0,
                 floor: float = 1e-3, k: int = 1, bm: int = 1, rows=None,
                 splits=None):
    """The tile kernel's launch, on operands :func:`launch` has checked:
    the tile rows (:func:`tile_rows`, narrowed where the wide tile's shared
    memory does not fit) and the column split (:func:`column_splits`) are
    chosen here, unless ``rows`` / ``splits`` name them; where neither is
    named and the autotuner is on (``autotune.configure``), its winner for
    this shape bucket takes their place: its tile rows where
    :func:`tile_rows` allows them, its multiple of the rule's split."""
    (m, d), n = e1.shape, e2.shape[0]
    dev = e1.device
    f32, i32 = torch.float32, torch.int32
    block_counts = vals = idx = row_sums = None
    tuned = None
    if rows is None and splits is None and flags in TUNED_OPS:
        from . import autotune

        tuned = autotune.schedule(TUNED_OPS[flags], m, n, d, mode, dev)
    allowed = tile_rows(m, m)
    if flags & HIST:
        check_operand(scale, "scale", f32, (m,))
        n_tiles = -(-m // bm)
        if bm % CTA_ROWS and n_tiles > 1:
            raise ValueError(f"block rows {bm} must be a multiple of {CTA_ROWS}")
        block_counts = torch.zeros((n_tiles, n_bins), dtype=i32, device=dev)
        allowed = tile_rows(m, bm)
    if rows is None:
        rows = allowed if tuned is None else min(tuned[0], allowed)
    elif rows > allowed:
        raise ValueError(f"{rows}-row tiles do not fit count tiles of {bm} rows")
    so = lib()
    smem = so.repro_sim_smem_bytes(flags, n_bins, k, rows)
    if smem > MAX_SMEM and rows == WIDE_ROWS:
        rows = CTA_ROWS
        smem = so.repro_sim_smem_bytes(flags, n_bins, k, rows)
    if smem > MAX_SMEM:
        raise ValueError(f"launch needs {smem} B of shared memory (> {MAX_SMEM})")
    if splits is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if tuned is None:
            splits = column_splits(m, n, sms, rows)
        else:
            splits = autotune.apply_split(m, n, sms, rows, tuned[1])
    # per-range outputs for the merge kernel; freed after the call, which is
    # safe because the allocator reuses memory in stream order and both
    # kernels run on the current stream
    part_vals = part_idx = part_sums = None
    if flags & TOPK:
        vals = torch.empty((m, k), dtype=f32, device=dev)
        idx = torch.empty((m, k), dtype=i32, device=dev)
        if splits > 1:
            part_vals = torch.empty((m, splits, k), dtype=f32, device=dev)
            part_idx = torch.empty((m, splits, k), dtype=i32, device=dev)
    if flags & SUMS:
        check_operand(v, "v", f32, (n,))
        row_sums = torch.empty((m,), dtype=f32, device=dev)
        if splits > 1:
            part_sums = torch.empty((m, splits, 2), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = so.repro_sim_launch(
            MODES[mode], flags, ptr(e1), ptr(e2), ptr(rs1), ptr(rs2),
            ptr(scale), ptr(v), m, n, d, n_bins, float(exponent),
            float(rs_exponent), float(floor), k, bm, rows, splits,
            ptr(part_vals), ptr(part_idx), ptr(part_sums), ptr(block_counts),
            ptr(vals), ptr(idx), ptr(row_sums), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"repro_sim_launch(mode={mode}, flags={flags}) "
                           f"failed with CUDA error {err}")
    return block_counts, vals, idx, row_sums


def _launch_few_rows(so, e1, e2, k):
    """The few-row top-k: (vals, idx), with one scratch allocation for the
    score keys (M, N) and their top-digit counts (M, 256), freed after the
    call (the allocator reuses memory in stream order)."""
    (m, d), n = e1.shape, e2.shape[0]
    dev = e1.device
    scratch = torch.empty(m * (n + 256), dtype=torch.int32, device=dev)
    keys, top = scratch[:m * n], scratch[m * n:]
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = so.repro_topk_few_rows(ptr(e1), ptr(e2), m, n, d, k, ptr(keys), ptr(top),
                                     ptr(vals), ptr(idx), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"repro_topk_few_rows(M={m}, N={n}, k={k}) failed "
                           f"with CUDA error {err}")
    return vals, idx


def pad_cols(t: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the embedding width to a multiple of ``mult`` (zero columns
    add exact zeros to every dot product)."""
    pad = (-t.shape[1]) % mult
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    return t.contiguous()
