"""Atomic save / load for the shared label store
(``repro_torch.serve.label_store``).

Layout — one directory per segment, addressed by the sha256 of the segment
key's canonical JSON form::

    <root>/<digest>/
        meta.json       # format, canonical key, entry count, dtypes
        keys.npy        # sorted int64 flat tuple keys
        vals.npy        # float64 labels aligned with keys

Guarantees mirror ``repro_torch.checkpoint.index_io`` (the stratification
index store this sits alongside):

  * atomic — written to ``<root>/.tmp_<digest>`` then ``os.replace``'d, so a
    crash mid-save never leaves a partially written segment visible;
  * self-verifying — ``meta.json`` records the canonical key and the entry
    count; :func:`load_segments` cross-checks the digest, the count, and the
    dtypes and raises ``ValueError`` instead of hydrating garbage;
  * pure numpy — no torch import, so a restarting service hydrates its hot
    labels without initialising a device.

The layout, the digest and the manifest are the reference package's
(``repro.checkpoint.label_io``) byte for byte: a segment saved by either
package loads in the other.

Only *stable* segment keys are stored (``label_store.persistable_key``):
tuples of str/int/float/bool, e.g. a named scorer group
``("scorer", "default", 0.5)`` or a wire group ``("wire", "default")`` plus
its encoding.  id()-derived process-local keys never reach this module.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

LABEL_STORE_FORMAT = 1


def canonical_key(key) -> list:
    """Segment key (nested tuples) -> the JSON-stable nested-list form."""
    if isinstance(key, (tuple, list)):
        return [canonical_key(k) for k in key]
    return key


def _tuplify(obj):
    if isinstance(obj, list):
        return tuple(_tuplify(o) for o in obj)
    return obj


def segment_digest(key) -> str:
    blob = json.dumps(canonical_key(key), separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def save_segment(root: str, key, keys: np.ndarray,
                 vals: np.ndarray) -> str:
    """Atomic save of one segment (overwrites any previous version of the
    same key).  Returns the final directory."""
    keys = np.ascontiguousarray(np.asarray(keys, np.int64))
    vals = np.ascontiguousarray(np.asarray(vals, np.float64))
    if keys.shape != vals.shape:
        raise ValueError(
            f"segment arrays misaligned: {keys.shape} keys, {vals.shape} vals"
        )
    digest = segment_digest(key)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp_{digest}")
    final = os.path.join(root, digest)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "keys.npy"), keys)
    np.save(os.path.join(tmp, "vals.npy"), vals)
    meta = {
        "format": LABEL_STORE_FORMAT,
        "key": canonical_key(key),
        "count": int(len(keys)),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_segments(root: str) -> list:
    """Every stored segment as ``(key, keys, vals)`` (arrays mmapped
    read-only — the store copies on first merge).  Raises ``ValueError`` on
    format mismatch, digest mismatch, or truncated arrays."""
    out = []
    if not os.path.isdir(root):
        return out
    for d in sorted(os.listdir(root)):
        path = os.path.join(root, d)
        meta_path = os.path.join(path, "meta.json")
        if d.startswith(".") or not os.path.isfile(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != LABEL_STORE_FORMAT:
            raise ValueError(
                f"{path}: label store format {meta.get('format')} != "
                f"{LABEL_STORE_FORMAT}"
            )
        key = _tuplify(meta["key"])
        if segment_digest(key) != d:
            raise ValueError(
                f"{path}: stored key does not hash to its directory name "
                f"— misplaced segment"
            )
        keys = np.load(os.path.join(path, "keys.npy"), mmap_mode="r")
        vals = np.load(os.path.join(path, "vals.npy"), mmap_mode="r")
        if len(keys) != meta["count"] or len(vals) != meta["count"]:
            raise ValueError(
                f"{path}: arrays hold {len(keys)}/{len(vals)} entries, "
                f"manifest says {meta['count']}"
            )
        if keys.dtype != np.int64 or vals.dtype != np.float64:
            raise ValueError(
                f"{path}: dtypes {keys.dtype}/{vals.dtype}, expected "
                f"int64/float64"
            )
        out.append((key, keys, vals))
    return out


__all__ = ["LABEL_STORE_FORMAT", "canonical_key", "segment_digest",
           "save_segment", "load_segments"]
