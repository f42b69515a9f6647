"""End to end: process start to the first timed query: the kernels' build
or load, the tables, the weights, the Oracle's threshold and the warm-up
query (host clock)."""

DEVICE = False


def read(ctx):
    return ctx.setup_s
