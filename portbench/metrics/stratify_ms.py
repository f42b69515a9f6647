"""Stratification (``core/stratify.py``, stage 1 of
``core/bas_streaming.py``, with the uploads): the mean per completed query
of the system's ``stratify_s`` span."""
import numpy as np

DEVICE = False


def read(ctx):
    vals = [r.timings["stratify_s"] for r in ctx.window.completed if "stratify_s" in r.timings]
    return float(np.mean(vals)) * 1e3 if vals else None
