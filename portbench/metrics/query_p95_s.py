"""End to end: the 95th percentile of the latency of every query completed
in the window, from submit to result (host clock; linear interpolation
between order statistics)."""
import numpy as np

DEVICE = False


def read(ctx):
    lat = [r.latency_s for r in ctx.window.completed]
    return float(np.percentile(lat, 95)) if lat else None
