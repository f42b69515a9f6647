"""Roofline report helpers (the reference's ``roofline/report.py``):
analytic MODEL_FLOPS and table generation from dry-run JSON records, over
the H100's constants (``roofline.hw``)."""
from __future__ import annotations

import glob
import json
import os
from typing import TYPE_CHECKING

from . import hw

if TYPE_CHECKING:  # the kernel ops import this package, and the models import them
    from ..models.config import ModelConfig


def model_flops(cfg: ModelConfig, shape: dict) -> float:
    """Analytic useful FLOPs per step: 6*N*D for training, 2*N*D for prefill,
    2*N*B for one decode token (N = active params for MoE)."""
    n = cfg.active_param_count()
    if shape["kind"] == "train":
        tokens = shape["batch"] * shape["seq"]
        return 6.0 * n * tokens
    if shape["kind"] == "prefill":
        tokens = shape["batch"] * shape["seq"]
        return 2.0 * n * tokens
    return 2.0 * n * shape["batch"]  # decode: one token per sequence


def load_records(out_dir: str) -> list:
    recs = []
    for fn in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def roofline_table(recs: list, mesh: str = "16x16") -> str:
    """Markdown roofline table (single-pod records by default).  Where the
    records say whether a rank fits the card (the port's ``fits``), a last
    column gives it; the reference's records make the reference's table."""
    recs = [r for r in recs if r.get("mesh") == mesh
            and r.get("rules", "default") == "default" and not r.get("tag")]
    fits = any("fits" in r for r in recs)
    more = (" fits |", "---|", " — |") if fits else ("", "", "")
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS/chip | useful ratio | mem/chip GiB |" + more[0],
        "|---|---|---|---|---|---|---|---|---|" + more[1],
    ]
    for r in recs:
        if r["status"] == "skipped":
            rows.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped: "
                f"{r['reason']} | — | — | — |" + more[2]
            )
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |"
                        + (" |" if fits else ""))
            continue
        rf = r["roofline"]
        rows.append(
            "| {arch} | {shape} | {c:.3e} | {m:.3e} | {x:.3e} | {dom} | "
            "{mf:.3e} | {ur:.2f} | {mem:.2f} |".format(
                arch=r["arch"], shape=r["shape"], c=rf["compute_s"],
                m=rf["memory_s"], x=rf["collective_s"], dom=rf["dominant"],
                mf=r["model_flops_per_chip"], ur=r["useful_compute_ratio"],
                mem=r["memory"]["total_bytes"] / 2**30,
            )
            + (f" {'yes' if r['fits'] else 'no'} |" if fits else "")
        )
    return "\n".join(rows)


def roofline_fraction(rec: dict) -> float:
    """Achieved fraction of the compute roofline: useful model FLOPs per chip
    over (bound time x peak).  This is the MFU-style score the perf loop
    drives up."""
    if rec.get("status") != "ok":
        return 0.0
    bound = rec["roofline"]["bound_s"]
    if bound <= 0:
        return 0.0
    return rec["model_flops_per_chip"] / (bound * hw.PEAK_FLOPS_BF16)
