"""Stratification (``kernels/sim_sweep/ops.py``, ``core/stratify.py``): the
copies of both tables to the card inside ``stratify_s``, with their padding
on the host: the mean per completed query of the system's
``sweep_upload_s`` span, in ms."""
from harness.program_log import span_mean_ms

DEVICE = False


def read(ctx):
    return span_mean_ms(ctx, "sweep_upload_s")
