"""Atomic save / mmap load for stratification index artifacts.

Layout (one directory per content key, one subdirectory per version)::

    <root>/<key>/v_00000001/
        meta.json         # scalar fields, stats, array manifest, format
        counts.npy
        edges.npy
        block_counts.npy
        emb_0.npy ... emb_{k-1}.npy
        topk_vals.npy topk_idx.npy topk_valid.npy   # two-table kernel builds
        row_sums_0.npy ... row_sums_{k-2}.npy       # fp32-effective builds

Guarantees:
  * atomic — written to ``<key>/.tmp_<version>`` then ``os.replace``'d, so
    a partially written artifact is never visible;
  * zero-copy read — arrays load with ``np.load(mmap_mode="r")``: opening an
    index touches only ``meta.json``; tile/top-k/embedding pages fault in as
    queries consume them, so a warm query's load cost is file-open, not a
    table read;
  * self-verifying — ``meta.json`` records the content key and the array
    manifest; :func:`load_index` cross-checks both and raises ``ValueError``
    on truncated or mixed-up directories instead of hydrating garbage;
  * versioned — ``append_rows`` bumps ``IndexArtifact.version``;
    :func:`save_index` writes each version to its own subdirectory and
    :func:`load_index` picks the newest by default, so a reader holding an
    old mmap keeps a consistent snapshot while a refresh lands next to it.

The module is pure numpy (no torch work): the index store and the
``build-index`` launcher load artifacts without touching the card.  The
layout is the reference package's, byte for byte (same file names, manifest
and format number), so an artifact written by either package loads in the
other.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from ..core.index import INDEX_FORMAT, IndexArtifact

_SCALARS = ("key", "version", "n_bins", "exponent", "floor", "precision",
            "precision_requested", "kernel", "block_rows")
_TOPK = ("topk_vals", "topk_idx", "topk_valid")


def _version_dirs(key_dir: str) -> dict:
    """{version: path} of complete (manifest-bearing) version directories."""
    if not os.path.isdir(key_dir):
        return {}
    out = {}
    for d in os.listdir(key_dir):
        if d.startswith("v_") and d[2:].isdigit() and os.path.isfile(
            os.path.join(key_dir, d, "meta.json")
        ):
            out[int(d[2:])] = os.path.join(key_dir, d)
    return out


def save_index(root: str, art: IndexArtifact, keep_last: int = 2) -> str:
    """Atomic save of one artifact version.  Returns the final directory.
    Old versions beyond ``keep_last`` are pruned (0 keeps everything)."""
    key_dir = os.path.join(root, art.key)
    os.makedirs(key_dir, exist_ok=True)
    tmp = os.path.join(key_dir, f".tmp_{art.version:08d}")
    final = os.path.join(key_dir, f"v_{art.version:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {"counts": np.asarray(art.counts),
              "edges": np.asarray(art.edges),
              "block_counts": np.asarray(art.block_counts)}
    for i, e in enumerate(art.embeddings):
        arrays[f"emb_{i}"] = np.asarray(e)
    if art.topk_vals is not None:
        arrays["topk_vals"] = np.asarray(art.topk_vals)
        arrays["topk_idx"] = np.asarray(art.topk_idx)
        arrays["topk_valid"] = np.asarray(art.topk_valid)
    if art.row_sums is not None:
        for j, rs in enumerate(art.row_sums):
            arrays[f"row_sums_{j}"] = np.asarray(rs, np.float64)

    manifest = {}
    for name, arr in arrays.items():
        np.save(os.path.join(tmp, f"{name}.npy"), arr)
        manifest[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    meta = {s: getattr(art, s) for s in _SCALARS}
    meta.update(
        format=INDEX_FORMAT,
        sizes=list(art.sizes),
        n_tables=len(art.embeddings),
        total_weight=art.total_weight,
        stats=art.stats,
        arrays=manifest,
    )
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    if keep_last > 0:
        versions = _version_dirs(key_dir)
        for v in sorted(versions)[:-keep_last]:
            shutil.rmtree(versions[v], ignore_errors=True)
    return final


def latest_version(root: str, key: str) -> Optional[int]:
    versions = _version_dirs(os.path.join(root, key))
    return max(versions) if versions else None


def list_indexes(root: str) -> list:
    """[{key, version, sizes, n_bins, precision}] of every stored artifact
    (newest version per key), sorted by key."""
    out = []
    if not os.path.isdir(root):
        return out
    for key in sorted(os.listdir(root)):
        versions = _version_dirs(os.path.join(root, key))
        if not versions:
            continue
        with open(os.path.join(versions[max(versions)], "meta.json")) as f:
            meta = json.load(f)
        out.append({
            "key": key, "version": max(versions),
            "sizes": tuple(meta["sizes"]), "n_bins": meta["n_bins"],
            "precision": meta["precision"],
        })
    return out


def load_index(root: str, key: str, version: Optional[int] = None,
               mmap: bool = True) -> IndexArtifact:
    """Load one artifact (newest version by default), arrays mmapped
    read-only.  Raises ``FileNotFoundError`` when the key/version is not
    stored, ``ValueError`` when the directory is corrupt (missing arrays,
    manifest/file shape mismatch, or a key that does not match its
    directory)."""
    if version is None:
        version = latest_version(root, key)
        if version is None:
            raise FileNotFoundError(f"no index stored under {root}/{key}")
    path = os.path.join(root, key, f"v_{version:08d}")
    meta_path = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"no index version at {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != INDEX_FORMAT:
        raise ValueError(
            f"{path}: index format {meta.get('format')} != {INDEX_FORMAT}"
        )
    if meta["key"] != key:
        raise ValueError(
            f"{path}: stored key {meta['key'][:12]}... does not match "
            f"directory {key[:12]}... — misplaced artifact"
        )

    mode = "r" if mmap else None

    def arr(name):
        fn = os.path.join(path, f"{name}.npy")
        if not os.path.isfile(fn):
            raise ValueError(f"{path}: missing array {name}.npy")
        a = np.load(fn, mmap_mode=mode)
        want = meta["arrays"].get(name)
        if want is None or list(a.shape) != want["shape"] or \
                str(a.dtype) != want["dtype"]:
            raise ValueError(
                f"{path}: array {name} is {a.shape}/{a.dtype}, manifest "
                f"says {want}"
            )
        return a

    embeddings = [arr(f"emb_{i}") for i in range(meta["n_tables"])]
    topk = {n: (arr(n) if n in meta["arrays"] else None) for n in _TOPK}
    row_sums = None
    if "row_sums_0" in meta["arrays"]:
        row_sums = [arr(f"row_sums_{j}")
                    for j in range(meta["n_tables"] - 1)]
    return IndexArtifact(
        key=meta["key"], version=meta["version"],
        sizes=tuple(meta["sizes"]), n_bins=meta["n_bins"],
        exponent=meta["exponent"], floor=meta["floor"],
        precision=meta["precision"],
        precision_requested=meta["precision_requested"],
        kernel=meta["kernel"], block_rows=meta["block_rows"],
        counts=arr("counts"), edges=arr("edges"),
        block_counts=arr("block_counts"),
        embeddings=embeddings,
        topk_vals=topk["topk_vals"], topk_idx=topk["topk_idx"],
        topk_valid=topk["topk_valid"],
        row_sums=row_sums,
        total_weight=meta.get("total_weight"),
        stats=meta.get("stats", {}),
    )
