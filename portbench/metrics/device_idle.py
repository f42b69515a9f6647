"""Device (H100): the share of the traced window covered by no device
activity (the union of kernel, copy and set intervals from the profiler),
in %."""

DEVICE = True


def read(ctx):
    tr = ctx.window.trace
    if tr is None or tr.busy_s <= 0 or ctx.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx.window.window_s)
