"""Estimate and CI (``core/bootstrap.py``): the mean per completed query of
the system's ``ci_s`` span."""
import numpy as np

DEVICE = False


def read(ctx):
    vals = [r.timings["ci_s"] for r in ctx.window.completed if "ci_s" in r.timings]
    return float(np.mean(vals)) * 1e3 if vals else None
