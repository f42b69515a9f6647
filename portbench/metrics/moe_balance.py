"""Model (``models/layers.moe_dropless_mlp``): how evenly the dropless MoE
loads its experts, in %: the system's counters ``moe.routed`` (T k routed
(token, expert) rows, every MoE layer) over ``moe.routed_peak`` (E times
the rows of the layer's busiest expert) in the traced window.  100% is
even load; below it, the busiest expert, the straggler of the grouped
products, sets the pace.  The scorer's padding rows route too and count
here.  A program without the dropless dispatch logs neither, and this
reads nothing."""
from harness.program_log import share

DEVICE = False


def read(ctx):
    return share("moe.routed", "moe.routed_peak")
