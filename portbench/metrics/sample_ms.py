"""Sampling and labelling (``core/bas.py`` pilot, allocation and execution,
``core/wander.py``): the mean per completed query of the system's
``walk_setup_s`` + ``pilot_s`` + ``allocate_s`` + ``execute_s`` spans."""
import numpy as np

DEVICE = False
SPANS = ("walk_setup_s", "pilot_s", "allocate_s", "execute_s")


def read(ctx):
    vals = [sum(r.timings[s] for s in SPANS) for r in ctx.window.completed
            if all(s in r.timings for s in SPANS)]
    return float(np.mean(vals)) * 1e3 if vals else None
