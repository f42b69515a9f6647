"""Model (``models/layers.moe_mlp``): the share of the MoE's capacity slots
that a routed token fills, in %: the system's counters ``moe.kept`` over
``moe.slots`` (groups x experts x capacity, every layer) in the traced
window.  Capacity 1.25 caps it at 80%; padding rows' tokens fill slots
too."""
from harness.program_log import share

DEVICE = False


def read(ctx):
    return share("moe.kept", "moe.slots")
